"""Host-side WordPiece tokenizer for the embedding model (copy of the JAX
package's ``models/tokenizer.py``; same vocab files, same ids).

The reference declared a tokenizer path + the ``tokenizers`` crate but never
wired it (``reference Cargo.toml:31`` commented out;
``src/vector.rs:168-181`` embeds nothing). This module implements the real
thing, self-contained:

* :class:`WordPieceTokenizer` — BERT-style basic tokenization (lowercase,
  accent strip, punctuation split) + greedy longest-match WordPiece with
  ``##`` continuation pieces and ``[CLS]/[SEP]/[PAD]/[UNK]`` specials.
* :func:`train_wordpiece_vocab` — offline vocab training from a corpus
  (frequency-pruned words + character/suffix pieces), so the system works
  with zero downloaded assets.
* When a HuggingFace ``tokenizer.json`` exists at the configured path and
  the ``tokenizers`` package is importable, it is used instead (exact
  MiniLM-compatible tokenization for pretrained checkpoints).

Output is always fixed-shape ``int32`` ``(input_ids, attention_mask)``
batches — static shapes for jit (SURVEY.md §7 design stance).
"""

from __future__ import annotations

import collections
import json
import unicodedata
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = (PAD, UNK, CLS, SEP, MASK)


def _basic_clean(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
            if ch not in ("\t", "\n", "\r"):
                continue
        if ch.isspace():
            out.append(" ")
        else:
            out.append(ch)
    return "".join(out)


def _strip_accents(text: str) -> str:
    return "".join(
        c for c in unicodedata.normalize("NFD", text)
        if unicodedata.category(c) != "Mn"
    )


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lowercase: bool = True) -> list[str]:
    """BERT basic tokenizer: clean, lowercase+de-accent, split punctuation."""
    text = _basic_clean(text)
    if lowercase:
        text = _strip_accents(text.lower())
    tokens: list[str] = []
    for word in text.split():
        cur = []
        for ch in word:
            if _is_punct(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


@dataclass
class EncodedBatch:
    input_ids: np.ndarray  # int32 [B, L]
    attention_mask: np.ndarray  # int32 [B, L]


class WordPieceTokenizer:
    """Greedy longest-match WordPiece over a fixed vocab."""

    def __init__(
        self,
        vocab: dict[str, int],
        lowercase: bool = True,
        max_input_chars_per_word: int = 100,
    ):
        if any(s not in vocab for s in (PAD, UNK, CLS, SEP)):
            raise ValueError("vocab must contain [PAD], [UNK], [CLS], [SEP]")
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.lowercase = lowercase
        self.max_input_chars_per_word = max_input_chars_per_word
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]

    def __len__(self) -> int:
        return len(self.vocab)

    # -- core ---------------------------------------------------------------

    def wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_input_chars_per_word:
            return [UNK]
        pieces: list[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for word in basic_tokenize(text, self.lowercase):
            out.extend(self.wordpiece(word))
        return out

    def encode(self, text: str, max_length: int = 128) -> tuple[list[int], list[int]]:
        """Single text → ([CLS] ids [SEP], mask), truncated/padded to
        ``max_length``."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = ids[: max_length - 2]
        ids = [self.cls_id] + ids + [self.sep_id]
        mask = [1] * len(ids)
        while len(ids) < max_length:
            ids.append(self.pad_id)
            mask.append(0)
        return ids, mask

    def encode_batch(
        self, texts: Sequence[str], max_length: int = 128
    ) -> EncodedBatch:
        ids = np.empty((len(texts), max_length), dtype=np.int32)
        mask = np.empty((len(texts), max_length), dtype=np.int32)
        for i, t in enumerate(texts):
            a, b = self.encode(t, max_length)
            ids[i] = a
            mask[i] = b
        return EncodedBatch(input_ids=ids, attention_mask=mask)

    # -- persistence --------------------------------------------------------

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(
            json.dumps({"vocab": self.vocab, "lowercase": self.lowercase}),
            encoding="utf-8",
        )

    @classmethod
    def load(cls, path: str | Path) -> "WordPieceTokenizer":
        d = json.loads(Path(path).read_text(encoding="utf-8"))
        if "vocab" in d and isinstance(d["vocab"], dict):
            return cls(d["vocab"], lowercase=d.get("lowercase", True))
        # HuggingFace tokenizer.json layout
        model = d.get("model", {})
        if model.get("type") == "WordPiece":
            return cls(model["vocab"], lowercase=True)
        raise ValueError(f"Unrecognised tokenizer file: {path}")


# ---------------------------------------------------------------------------
# Offline vocab training
# ---------------------------------------------------------------------------


def train_wordpiece_vocab(
    corpus: Iterable[str],
    vocab_size: int = 8192,
    min_frequency: int = 2,
    lowercase: bool = True,
) -> dict[str, int]:
    """Train a WordPiece-style vocab from raw texts.

    Simplified WordPiece training tuned for the offline case: specials +
    all seen single characters (and their ``##`` forms) guarantee lossless
    coverage; the remaining budget goes to the highest-frequency whole words
    and word prefixes (as ``##``-free pieces) / suffixes (as ``##`` pieces),
    so common legal vocabulary tokenizes to 1-2 pieces.
    """
    word_freq: collections.Counter[str] = collections.Counter()
    for text in corpus:
        for w in basic_tokenize(text, lowercase):
            word_freq[w] += 1

    vocab: dict[str, int] = {}
    for s in SPECIALS:
        vocab[s] = len(vocab)

    # Character coverage (both initial and continuation forms).
    chars: collections.Counter[str] = collections.Counter()
    for w, f in word_freq.items():
        for ch in w:
            chars[ch] += f
    for ch, _ in chars.most_common():
        for piece in (ch, f"##{ch}"):
            if piece not in vocab and len(vocab) < vocab_size:
                vocab[piece] = len(vocab)

    # Whole words by frequency.
    for w, f in word_freq.most_common():
        if f < min_frequency:
            break
        if len(vocab) >= vocab_size:
            break
        if w not in vocab:
            vocab[w] = len(vocab)

    # Frequent suffix pieces (lengths 2..6) to split unseen inflections.
    if len(vocab) < vocab_size:
        suffixes: collections.Counter[str] = collections.Counter()
        prefixes: collections.Counter[str] = collections.Counter()
        for w, f in word_freq.items():
            for k in range(2, min(6, len(w))):
                suffixes[f"##{w[-k:]}"] += f
                prefixes[w[:k]] += f
        merged = suffixes + prefixes
        for piece, f in merged.most_common():
            if f < min_frequency or len(vocab) >= vocab_size:
                break
            if piece not in vocab:
                vocab[piece] = len(vocab)

    return vocab


def load_tokenizer(
    tokenizer_path: str | Path,
    fallback_corpus: Optional[Iterable[str]] = None,
    vocab_size: int = 8192,
) -> WordPieceTokenizer:
    """Resolve a tokenizer: HF ``tokenizers`` lib if the file is a HF
    tokenizer.json, else our JSON format, else train from ``fallback_corpus``.
    """
    path = Path(tokenizer_path)
    if path.exists():
        try:
            return WordPieceTokenizer.load(path)
        except (ValueError, KeyError, json.JSONDecodeError):
            pass
        try:  # full HF pipeline via the tokenizers package
            return _HFTokenizerAdapter(path)  # type: ignore[return-value]
        except Exception:
            pass
    if fallback_corpus is not None:
        vocab = train_wordpiece_vocab(fallback_corpus, vocab_size=vocab_size)
        return WordPieceTokenizer(vocab)
    # Minimal char-level vocab: always functional.
    chars = {c: None for c in "abcdefghijklmnopqrstuvwxyz0123456789.,'()-"}
    vocab = {}
    for s in SPECIALS:
        vocab[s] = len(vocab)
    for c in chars:
        vocab[c] = len(vocab)
        vocab[f"##{c}"] = len(vocab)
    return WordPieceTokenizer(vocab)


class _HFTokenizerAdapter(WordPieceTokenizer):
    """Adapter over ``tokenizers.Tokenizer`` exposing the same interface."""

    def __init__(self, path: Path):
        from tokenizers import Tokenizer  # baked into the image

        self._tk = Tokenizer.from_file(str(path))
        vocab = self._tk.get_vocab()
        super().__init__(vocab, lowercase=True)

    def tokenize(self, text: str) -> list[str]:
        return self._tk.encode(text, add_special_tokens=False).tokens

    def encode(self, text: str, max_length: int = 128) -> tuple[list[int], list[int]]:
        enc = self._tk.encode(text, add_special_tokens=False)
        ids = list(enc.ids)[: max_length - 2]
        ids = [self.cls_id] + ids + [self.sep_id]
        mask = [1] * len(ids)
        while len(ids) < max_length:
            ids.append(self.pad_id)
            mask.append(0)
        return ids, mask
