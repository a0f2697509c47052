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
and runs of anything else ``[^\s\p{L}\p{N}]+``. ``re`` has no property
classes, so :func:`_classes` builds them once, at first use, as code-point
ranges from :mod:`unicodedata`: ``\p{L}`` is every code point of category
``L*``, ``\p{N}`` every one of ``N*``, and ``\s`` the Unicode
``White_Space`` set that ``regex`` matches (``re``'s own ``\s`` adds
U+001C-U+001F). Case folding is as ``regex``'s: the letter and number
classes match without it, the class of the rest with it (a combining mark,
U+0345, folds to ``ι``: it is no letter, nor is it in the rest, so neither
engine gives it a piece). ``regex`` carries newer Unicode tables than the
interpreter's :mod:`unicodedata`, so the two can differ only on code points
that the interpreter's Unicode version leaves unassigned.
"""

__all__ = ['SimpleTokenizer', 'tokenize']

import functools
import gzip
import html
import itertools
import pathlib
import re
import sys
import unicodedata

import numpy as np

# Unicode White_Space: what ``regex`` (and the original pattern) means by \s
_WHITE_SPACE = '\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000'


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


@functools.lru_cache()
def _classes() -> tuple[str, str]:
    r"""The bodies of the character classes ``\p{L}`` and ``\p{N}`` for
    ``re``: runs of code points of category ``L*`` and ``N*``."""
    runs: dict[str, list[tuple[int, int]]] = {'L': [], 'N': []}
    cps = range(sys.maxunicode + 1)
    majors = (c[0] for c in map(unicodedata.category, map(chr, cps)))
    start = 0
    for major, group in itertools.groupby(majors):
        n = sum(1 for _ in group)
        if major in runs:
            runs[major].append((start, start + n - 1))
        start += n

    def body(r):
        return ''.join(re.escape(chr(a)) if a == b else
                       f'{re.escape(chr(a))}-{re.escape(chr(b))}' for a, b in r)

    return body(runs['L']), body(runs['N'])


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
        letter, number = _classes()
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll"""
            rf"""|'d|(?-i:[{letter}]+|[{number}])|[^{_WHITE_SPACE}{letter}{number}]+""",
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
