"""BERT's WordPiece tokenization, frozen: clean, lowercase and strip
accents, split on whitespace and punctuation, then greedy longest-match
pieces with ``##`` continuations; ``[CLS] ... [SEP]``."""

from __future__ import annotations

import unicodedata


def _clean(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or (unicodedata.category(ch).startswith("C") and ch not in "\t\n\r"):
            continue
        out.append(" " if ch.isspace() else ch)
    return "".join(out)


def _punct(ch: str) -> bool:
    cp = ord(ch)
    return (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126) \
        or unicodedata.category(ch).startswith("P")


def words(text: str) -> list[str]:
    text = unicodedata.normalize("NFD", _clean(text).lower())
    text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    out: list[str] = []
    for word in text.split():
        cur = ""
        for ch in word:
            if _punct(ch):
                if cur:
                    out.append(cur)
                    cur = ""
                out.append(ch)
            else:
                cur += ch
        if cur:
            out.append(cur)
    return out


def pieces(word: str, vocab: dict[str, int]) -> list[str]:
    if len(word) > 100:
        return ["[UNK]"]
    out, start = [], 0
    while start < len(word):
        end = len(word)
        while end > start:
            sub = word[start:end] if start == 0 else "##" + word[start:end]
            if sub in vocab:
                out.append(sub)
                break
            end -= 1
        else:
            return ["[UNK]"]
        start = end
    return out


def token_ids(text: str, vocab: dict[str, int], max_length: int) -> list[int]:
    """``[CLS] pieces [SEP]`` ids, the pieces cut to ``max_length - 2``."""
    ids = [vocab.get(p, vocab["[UNK]"]) for w in words(text) for p in pieces(w, vocab)]
    return [vocab["[CLS]"], *ids[: max_length - 2], vocab["[SEP]"]]
