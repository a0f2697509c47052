r"""CLIP byte-pair-encoding tokenizer (OpenAI ``SimpleTokenizer``): a copy
of ``oadp_tpu/models/tokenizer.py`` whose pre-tokenising pattern is
written with the standard library's ``re`` instead of ``regex``.

Replaces the ``clip.tokenize`` / ``clip.adaptively_tokenize`` calls of
the reference prompt builders (``oadp/prompts/vild.py:64``). Pure
Python + numpy; the merges file is the standard
``bpe_simple_vocab_16e6.txt.gz`` shipped with CLIP checkpoints
(path configurable; tests construct miniature vocabularies).

``ftfy`` is not used: text cleaning is HTML-unescape + whitespace
normalization, which is lossless for the ASCII class names and prompt
templates used here.

The original's pattern splits letters ``\p{L}+``, single digits ``\p{N}``
and runs of anything else ``[^\s\p{L}\p{N}]+``. Here they are
``[^\W\d_]+``, ``\d`` and ``(?:[^\s\w]|_)+``: the same pieces on ASCII
text, which holds every COCO/LVIS name through every ViLD template. Other
Unicode can split otherwise: ``'x½'`` is one piece here and two there,
because ``re`` counts ``½`` as a word character and ``regex`` as a number.
"""

__all__ = ['SimpleTokenizer', 'tokenize']

import functools
import gzip
import html
import pathlib
import re

import numpy as np


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    bs = (
        list(range(ord('!'), ord('~') + 1))
        + list(range(ord('¡'), ord('¬') + 1))
        + list(range(ord('®'), ord('ÿ') + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r'\s+', ' ', text)
    return text.strip()


class SimpleTokenizer:

    def __init__(self, bpe_path: str | pathlib.Path):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        raw = gzip.open(bpe_path).read().decode('utf-8').split('\n')
        merges = [
            tuple(m.split()) for m in raw[1:49152 - 256 - 2 + 1] if m
        ]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + '</w>' for v in vocab]
        for merge in merges:
            vocab.append(''.join(merge))
        vocab.extend(['<|startoftext|>', '<|endoftext|>'])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            '<|startoftext|>': '<|startoftext|>',
            '<|endoftext|>': '<|endoftext|>',
        }
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll"""
            r"""|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
            re.IGNORECASE,
        )

    @property
    def sot(self) -> int:
        return self.encoder['<|startoftext|>']

    @property
    def eot(self) -> int:
        return self.encoder['<|endoftext|>']

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + '</w>',)
        pairs = _get_pairs(word)
        if not pairs:
            return token + '</w>'
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float('inf'))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (
                    word[i] == first and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = ' '.join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        tokens = []
        text = _clean(text).lower()
        for token in re.findall(self.pat, text):
            token = ''.join(
                self.byte_encoder[b] for b in token.encode('utf-8')
            )
            tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(' ')
            )
        return tokens


def tokenize(
    texts: list[str] | str,
    tokenizer: SimpleTokenizer,
    context_length: int = 77,
    truncate: bool = True,
) -> np.ndarray:
    """``(B, context_length)`` int32 token matrix (CLIP ``tokenize``)."""
    if isinstance(texts, str):
        texts = [texts]
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        tokens = [tokenizer.sot] + tokenizer.encode(text) + [tokenizer.eot]
        if len(tokens) > context_length:
            if not truncate:
                raise ValueError(f'too long: {text!r}')
            tokens = tokens[:context_length]
            tokens[-1] = tokenizer.eot
        out[i, :len(tokens)] = tokens
    return out
