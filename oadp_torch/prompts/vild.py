"""Build ViLD prompt embeddings: ``python -m oadp_torch.prompts.vild``
(port of ``oadp_tpu/prompts/vild.py``).

Reimplements reference ``oadp/prompts/vild.py``: encode every
COCO∪LVIS class name (1217 names) through 74 prompt templates with the
CLIP text encoder, average the *normalized* per-template embeddings (no
final re-normalization — reference ``:66-72``), save
``data/prompts/vild.pth`` as ``{names, embeddings}``.

The text encoder runs in fp32 on ``--device`` (default ``cuda``), with
``oadp_tpu``'s numerics: batches of 256 token rows, a short last batch
padded by repeating its last row, each template's embeddings
L2-normalised in fp64 on the host and their mean cast to fp32.
"""

__all__ = ['PROMPTS', 'build_vild_prompts', 'main']

import argparse
import pathlib

import numpy as np
import torch

from ..base import coco, lvis
from ..models import clip as C
from ..models.tokenizer import SimpleTokenizer, tokenize
from ..oake.encoders import _load_torch_checkpoint, resolve_device
from ..utils import logger, save_pth

PROMPTS = [
    "This is a {}", "There is a {}", "a photo of a {} in the scene",
    "a photo of a small {} in the scene",
    "a photo of a medium {} in the scene",
    "a photo of a large {} in the scene", "a photo of a {}",
    "a photo of a small {}", "a photo of a medium {}",
    "a photo of a large {}",
    "This is a photo of a {}", "This is a photo of a small {}",
    "This is a photo of a medium {}", "This is a photo of a large {}",
    "There is a {} in the scene", "There is the {} in the scene",
    "There is one {} in the scene", "This is a {} in the scene",
    "This is the {} in the scene", "This is one {} in the scene",
    "This is one small {} in the scene",
    "This is one medium {} in the scene",
    "This is one large {} in the scene",
    "There is a small {} in the scene",
    "There is a medium {} in the scene",
    "There is a large {} in the scene",
    "There is a {} in the photo", "There is the {} in the photo",
    "There is one {} in the photo", "There is a small {} in the photo",
    "There is the small {} in the photo",
    "There is one small {} in the photo",
    "There is a medium {} in the photo",
    "There is the medium {} in the photo",
    "There is one medium {} in the photo",
    "There is a large {} in the photo",
    "There is the large {} in the photo",
    "There is one large {} in the photo",
    "There is a {} in the picture", "There is the {} in the picture",
    "There is one {} in the picture",
    "There is a small {} in the picture",
    "There is the small {} in the picture",
    "There is one small {} in the picture",
    "There is a medium {} in the picture",
    "There is the medium {} in the picture",
    "There is one medium {} in the picture",
    "There is a large {} in the picture",
    "There is the large {} in the picture",
    "There is one large {} in the picture", "This is a {} in the photo",
    "This is the {} in the photo", "This is one {} in the photo",
    "This is a small {} in the photo",
    "This is the small {} in the photo",
    "This is one small {} in the photo",
    "This is a medium {} in the photo",
    "This is the medium {} in the photo",
    "This is one medium {} in the photo",
    "This is a large {} in the photo",
    "This is the large {} in the photo",
    "This is one large {} in the photo",
    "This is a {} in the picture",
    "This is the {} in the picture", "This is one {} in the picture",
    "This is a small {} in the picture",
    "This is the small {} in the picture",
    "This is one small {} in the picture",
    "This is a medium {} in the picture",
    "This is the medium {} in the picture",
    "This is one medium {} in the picture",
    "This is a large {} in the picture",
    "This is the large {} in the picture",
    "This is one large {} in the picture",
]


def build_vild_prompts(
    text_params,
    tokenizer: SimpleTokenizer,
    names: list[str],
    config: C.TextConfig = C.TextConfig(),
    batch_size: int = 256,
    prompts: list[str] = PROMPTS,
) -> np.ndarray:
    """Mean over templates of L2-normalized text embeddings, on the device
    of ``text_params``.

    Every batch is queued on the device before any result is read, so the
    host tokenizes the next template while the device encodes; the fp64
    normalisation then runs template by template as in ``oadp_tpu``."""
    device = text_params['token_embedding'].device
    per_prompt = []
    with torch.inference_mode():
        for prompt in prompts:
            texts = [prompt.format(name) for name in names]
            embs = []
            for start in range(0, len(texts), batch_size):
                tokens = tokenize(
                    texts[start:start + batch_size], tokenizer,
                    config.context_length,
                )
                pad = batch_size - len(tokens)
                if pad:
                    tokens = np.concatenate(
                        [tokens, np.tile(tokens[-1:], (pad, 1))]
                    )
                out = C.text_encoder(
                    text_params, torch.from_numpy(tokens).to(device), config
                )
                embs.append(out[:len(texts[start:start + batch_size])])
            per_prompt.append(torch.cat(embs))
        total = np.zeros((len(names), config.output_dim), np.float64)
        for prompt, out in zip(prompts, per_prompt):
            emb = out.cpu().numpy().astype(np.float64)
            emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
            total += emb
            logger.info('encoded prompt %r', prompt)
    return (total / len(prompts)).astype(np.float32)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        '--checkpoint', default='pretrained/clip/ViT-B-32.pt'
    )
    parser.add_argument(
        '--bpe', default='pretrained/clip/bpe_simple_vocab_16e6.txt.gz'
    )
    parser.add_argument('--output', default='data/prompts/vild.pth')
    parser.add_argument(
        '--device', default='cuda',
        help='device of the text encoder (a CUDA request without a CUDA '
             'device raises)',
    )
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    names = sorted(set(coco.all_ + lvis.all_))
    state = _load_torch_checkpoint(args.checkpoint)
    if state is None:
        raise SystemExit(f'cannot load CLIP checkpoint {args.checkpoint}')
    text_params = C.load_openai_text_state_dict(state)
    if not text_params:
        raise SystemExit('checkpoint has no text tower')
    if device.type == 'cuda':
        # full fp32 products, as oadp_tpu's fp32 text encoder computes
        torch.backends.cuda.matmul.allow_tf32 = False
    text_params = C.map_params(text_params, lambda t: t.to(device))
    tokenizer = SimpleTokenizer(args.bpe)
    embeddings = build_vild_prompts(text_params, tokenizer, names)
    pathlib.Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    save_pth(dict(names=names, embeddings=embeddings), args.output)
    logger.info('saved %s (%d names)', args.output, len(names))


if __name__ == '__main__':
    main()
