"""Trie index: host builder → frozen CSR arrays → batched device walk.

Port of ``trie_semantic_search_tpu/index/trie.py``: three token-level tries
(case names, citations, content) with exact-match and prefix lookup,
frozen into CSR arrays with DFS pre-order node ids and the same ``.npz`` /
``.mmap`` artifact format, so tries saved by the JAX package load here
unchanged. The walk and postings gathers run in PyTorch
(:mod:`..ops.trie_kernels`) on the index's device. This module freezes with
the Python builder, which the JAX package holds bit-identical to its native
one. After ``load_from_disk`` the builders are rehydrated from the frozen
arrays at the first insert (``TrieBuilder.from_frozen``), so inserting into
a loaded index and freezing gives what the JAX package gives.
"""

from __future__ import annotations

import json
import re as _re
import shutil
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.config import TrieConfig
from ..core.errors import AutomatonCompilationFailed, IndexCorrupted
from ..device import DeviceLike, resolve_device
from ..ops.trie_kernels import (
    batched_walk,
    edge_keys,
    gather_postings_ranked,
    gather_range_postings_ranked,
)

#: word tokenization for the name/content tries: \w+ runs, lowercased
_WORD_RE = _re.compile(r"\w+")

#: stopwords delimiting content phrases (the JAX package's text processor
#: list), used by the "phrase_start" content windowing
_STOPWORDS: frozenset[str] = frozenset(
    """a an and are as at be by for from has he in is it its of on that the
    to was will with this but they have had what said each which she do how
    their if up out many then them these so some her would make like into him
    time two more go no way could my than first been call who oil sit now
    find down day did get come made may part""".split()
)

#: token id fed to the walk for out-of-vocabulary query tokens
UNKNOWN_TOKEN = -2
#: padding token id
PAD_TOKEN = -1


def word_tokens(text: str) -> list[str]:
    return _WORD_RE.findall(text.lower())


def _phrase_start_positions(toks: Sequence[str], mode: str) -> list[int]:
    """Window-start positions: 0 only (``sentence_start``), or 0 plus every
    stopword→non-stopword boundary (``phrase_start``)."""
    if mode == "sentence_start" or len(toks) <= 1:
        return [0]
    out = [0]
    for i in range(1, len(toks)):
        if toks[i] not in _STOPWORDS and toks[i - 1] in _STOPWORDS:
            out.append(i)
    return out


class _Node:
    __slots__ = ("children", "is_end", "postings", "frequency")

    def __init__(self) -> None:
        self.children: dict[int, "_Node"] = {}
        self.is_end = False
        self.postings: list[tuple[int, int]] = []
        self.frequency = 0


class TrieBuilder:
    """Host-side incremental trie over token-id paths."""

    def __init__(self) -> None:
        self.vocab: dict[str, int] = {}
        self.root = _Node()
        self.num_nodes = 1

    def token_id(self, token: str, create: bool = False) -> int:
        tid = self.vocab.get(token)
        if tid is None:
            if not create:
                return UNKNOWN_TOKEN
            tid = len(self.vocab)
            self.vocab[token] = tid
        return tid

    def insert(self, tokens: Sequence[str], case_row: int, para_idx: int = 0) -> None:
        if not tokens:
            return
        node = self.root
        for t in tokens:
            tid = self.token_id(t, create=True)
            child = node.children.get(tid)
            if child is None:
                child = _Node()
                node.children[tid] = child
                self.num_nodes += 1
            node = child
        node.is_end = True
        node.postings.append((case_row, para_idx))
        node.frequency += 1

    @classmethod
    def from_frozen(cls, frozen: "FrozenTrie") -> "TrieBuilder":
        """A builder holding ``frozen``'s paths, postings (in their per-node
        order), end flags and frequencies: ``from_frozen(f).freeze()``
        gives ``f`` back bit for bit."""
        b = cls()
        b.vocab = dict(frozen.vocab)
        N = frozen.num_nodes
        nodes = [_Node() for _ in range(max(N, 1))]
        b.root = nodes[0]
        eo, et, tg = frozen.edge_offsets, frozen.edge_tokens, frozen.edge_targets
        po, pc, pp = frozen.post_offsets, frozen.post_case, frozen.post_para
        for n in range(N):
            node = nodes[n]
            for e in range(int(eo[n]), int(eo[n + 1])):
                node.children[int(et[e])] = nodes[int(tg[e])]
            s, e_ = int(po[n]), int(po[n + 1])
            node.postings = list(zip(pc[s:e_].tolist(), pp[s:e_].tolist()))
            node.is_end = bool(frozen.is_end[n])
            node.frequency = int(frozen.frequency[n])
        b.num_nodes = max(N, 1)
        return b

    def freeze(self) -> "FrozenTrie":
        """Compile to CSR arrays: DFS pre-order node ids (children in token
        order), postings in the same order, so a node's subtree postings
        are ``[post_offsets[n], subtree_post_end[n])``."""
        try:
            order: list[_Node] = []
            ids: dict[int, int] = {}
            stack: list[_Node] = [self.root]
            while stack:
                node = stack.pop()
                ids[id(node)] = len(order)
                order.append(node)
                for tid in sorted(node.children, reverse=True):
                    stack.append(node.children[tid])

            N = len(order)
            edge_offsets = np.zeros(N + 1, np.int32)
            post_offsets = np.zeros(N + 1, np.int32)
            is_end = np.zeros(N, bool)
            frequency = np.zeros(N, np.int32)
            edge_tokens: list[int] = []
            edge_targets: list[int] = []
            post_case: list[int] = []
            post_para: list[int] = []
            for n, node in enumerate(order):
                for tid in sorted(node.children):
                    edge_tokens.append(tid)
                    edge_targets.append(ids[id(node.children[tid])])
                edge_offsets[n + 1] = len(edge_tokens)
                for row, para in node.postings:
                    post_case.append(row)
                    post_para.append(para)
                post_offsets[n + 1] = len(post_case)
                is_end[n] = node.is_end
                frequency[n] = node.frequency

            size = np.ones(N, np.int64)
            post: list[tuple[_Node, bool]] = [(self.root, False)]
            while post:
                node, done = post.pop()
                if done:
                    n = ids[id(node)]
                    for child in node.children.values():
                        size[n] += size[ids[id(child)]]
                else:
                    post.append((node, True))
                    for child in node.children.values():
                        post.append((child, False))
            span_end = np.arange(N, dtype=np.int64) + size - 1
            subtree_post_end = post_offsets[span_end + 1].astype(np.int32)

            id_to_token = [""] * len(self.vocab)
            for tok, tid in self.vocab.items():
                id_to_token[tid] = tok
            return FrozenTrie(
                edge_offsets=edge_offsets,
                edge_tokens=np.asarray(edge_tokens, np.int32),
                edge_targets=np.asarray(edge_targets, np.int32),
                post_offsets=post_offsets,
                post_case=np.asarray(post_case, np.int32),
                post_para=np.asarray(post_para, np.int32),
                subtree_post_end=subtree_post_end,
                is_end=is_end,
                frequency=frequency,
                vocab=dict(self.vocab),
                id_to_token=id_to_token,
            )
        except (ValueError, OverflowError) as e:
            raise AutomatonCompilationFailed(str(e)) from e


@dataclass
class FrozenTrie:
    """Immutable compiled trie: host numpy arrays, uploaded once per device
    by :meth:`device`."""

    edge_offsets: np.ndarray
    edge_tokens: np.ndarray
    edge_targets: np.ndarray
    post_offsets: np.ndarray
    post_case: np.ndarray
    post_para: np.ndarray
    subtree_post_end: np.ndarray
    is_end: np.ndarray
    frequency: np.ndarray
    vocab: dict[str, int]
    id_to_token: list[str]

    _device_arrays: dict = field(default_factory=dict, repr=False)
    _post_weight: Optional[np.ndarray] = field(default=None, repr=False)

    _ARRAY_FIELDS = (
        "edge_offsets", "edge_tokens", "edge_targets", "post_offsets",
        "post_case", "post_para", "subtree_post_end", "is_end", "frequency",
    )

    @property
    def num_nodes(self) -> int:
        return len(self.is_end)

    @property
    def num_edges(self) -> int:
        return len(self.edge_tokens)

    @property
    def num_postings(self) -> int:
        return len(self.post_case)

    def nbytes(self) -> int:
        """Bytes of the traversal and posting arrays (the JAX package's
        count: ``subtree_post_end`` is left out there too)."""
        return sum(
            getattr(self, name).nbytes
            for name in self._ARRAY_FIELDS
            if name != "subtree_post_end"
        )

    def encode_queries(
        self, token_seqs: Sequence[Sequence[str]], max_len: int
    ) -> np.ndarray:
        """Token strings → ``[B, max_len]`` id matrix (PAD -1, UNK -2). Empty
        and over-long queries kill the lane."""
        out = np.full((len(token_seqs), max_len), PAD_TOKEN, np.int32)
        for b, toks in enumerate(token_seqs):
            if len(toks) == 0:
                out[b, 0] = UNKNOWN_TOKEN
                continue
            if len(toks) > max_len:
                out[b, :] = UNKNOWN_TOKEN
                continue
            for i, t in enumerate(toks):
                out[b, i] = self.vocab.get(t, UNKNOWN_TOKEN)
        return out

    def post_weights(self) -> np.ndarray:
        """Per-posting rank weight: postings of the same case at the same
        node (computed once from the frozen arrays)."""
        if self._post_weight is None:
            P = self.num_postings
            if P == 0:
                w = np.zeros(1, np.int32)
            else:
                node_of = np.repeat(
                    np.arange(self.num_nodes, dtype=np.int64),
                    np.diff(self.post_offsets).astype(np.int64),
                )
                span = int(self.post_case.max()) + 2
                key = node_of * span + (self.post_case.astype(np.int64) + 1)
                _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
                w = counts[inv].astype(np.int32)
            self._post_weight = w
        return self._post_weight

    def device(self, device: torch.device) -> dict:
        """Walk/gather arrays on ``device`` (uploaded once per device)."""
        key = str(device)
        if key not in self._device_arrays:
            tg = self.edge_targets if self.num_edges else np.zeros(1, np.int32)
            pc = self.post_case if self.num_postings else np.full(1, -1, np.int32)
            # copies: the host arrays may be read-only memmaps
            t = lambda a: torch.tensor(np.asarray(a), device=device)  # noqa: E731
            eo = t(self.edge_offsets)
            keys, mult = edge_keys(eo, t(self.edge_tokens))
            self._device_arrays[key] = dict(
                edge_keys=keys, key_mult=mult, edge_targets=t(tg),
                post_offsets=t(self.post_offsets), post_rows=t(pc),
                subtree_end=t(self.subtree_post_end), is_end=t(self.is_end),
                post_weight=t(self.post_weights()),
            )
        return self._device_arrays[key]

    def walk_and_gather(
        self, token_ids: np.ndarray, device: torch.device,
        max_postings: int = 64, prefix: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Batched walk + ranked postings gather → ``(nodes, rows, valid)``
        on ``device``. ``prefix`` gathers the node's whole subtree."""
        a = self.device(device)
        nodes = batched_walk(
            a["edge_keys"], a["key_mult"], a["edge_targets"],
            torch.as_tensor(token_ids, device=device),
        )
        if prefix:
            rows, valid = gather_range_postings_ranked(
                a["post_offsets"], a["subtree_end"], a["post_rows"],
                a["post_weight"], nodes, max_postings,
            )
        else:
            rows, valid = gather_postings_ranked(
                a["post_offsets"], a["post_rows"], a["post_weight"],
                a["is_end"], nodes, max_postings,
            )
        return nodes, rows, valid

    def completions(
        self, prefix_tokens: Sequence[str], limit: int = 10, max_depth: int = 50
    ) -> list[str]:
        """Prefix completions from the node ``prefix_tokens`` reach, ranked
        by insertion frequency (ties lexicographic)."""
        node = 0
        for t in prefix_tokens:
            tid = self.vocab.get(t)
            if tid is None:
                return []
            lo, hi = self.edge_offsets[node], self.edge_offsets[node + 1]
            span = self.edge_tokens[lo:hi]
            pos = np.searchsorted(span, tid)
            if pos >= len(span) or span[pos] != tid:
                return []
            node = int(self.edge_targets[lo + pos])
        collected: list[tuple[int, str]] = []
        budget = max(limit * 4, limit)
        prefix = list(prefix_tokens)
        stack: list[tuple[int, list[str]]] = [(node, prefix)]
        while stack and len(collected) < budget:
            cur, path = stack.pop()
            if self.is_end[cur] and len(path) > len(prefix):
                collected.append((int(self.frequency[cur]), " ".join(path)))
            if len(path) - len(prefix) >= max_depth:
                continue
            lo, hi = self.edge_offsets[cur], self.edge_offsets[cur + 1]
            for e in range(hi - 1, lo - 1, -1):
                tok = self.id_to_token[self.edge_tokens[e]]
                stack.append((int(self.edge_targets[e]), path + [tok]))
        collected.sort(key=lambda t: (-t[0], t[1]))
        return [c for _, c in collected[:limit]]

    def save(self, path: str | Path, mmap_format: bool = False) -> None:
        """Persist as one compressed ``.npz`` or, with ``mmap_format``, a
        directory of raw ``.npy`` files (the JAX package's formats)."""
        path = Path(path)
        mmap_dir = path.with_suffix(".mmap")
        if mmap_format:
            if mmap_dir.is_dir():
                shutil.rmtree(mmap_dir)
            mmap_dir.mkdir(parents=True, exist_ok=True)
            for name in self._ARRAY_FIELDS:
                np.save(mmap_dir / f"{name}.npy", getattr(self, name))
            (mmap_dir / "vocab.json").write_text(json.dumps(self.vocab))
            path.unlink(missing_ok=True)
            return
        if mmap_dir.is_dir():
            shutil.rmtree(mmap_dir)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path,
            **{name: getattr(self, name) for name in self._ARRAY_FIELDS},
            vocab_json=np.array(json.dumps(self.vocab)),
        )

    @staticmethod
    def _id_to_token(vocab: dict[str, int]) -> list[str]:
        out = [""] * len(vocab)
        for tok, tid in vocab.items():
            out[tid] = tok
        return out

    @classmethod
    def load(cls, path: str | Path) -> "FrozenTrie":
        mmap_dir = Path(path).with_suffix(".mmap")
        if mmap_dir.is_dir():
            return cls._load_mmap(mmap_dir)
        try:
            with np.load(path, allow_pickle=False) as z:
                vocab = json.loads(str(z["vocab_json"]))
                return cls(
                    vocab=vocab, id_to_token=cls._id_to_token(vocab),
                    **{name: z[name] for name in cls._ARRAY_FIELDS},
                )
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            raise IndexCorrupted(index_type="trie", details=str(e)) from e

    @classmethod
    def _load_mmap(cls, d: Path) -> "FrozenTrie":
        try:
            arrays = {
                name: np.load(d / f"{name}.npy", mmap_mode="r")
                for name in cls._ARRAY_FIELDS
            }
            vocab = json.loads((d / "vocab.json").read_text())
        except (OSError, ValueError, json.JSONDecodeError) as e:
            raise IndexCorrupted(index_type="trie", details=str(e)) from e
        return cls(vocab=vocab, id_to_token=cls._id_to_token(vocab), **arrays)


class TrieIndex:
    """Three-trie facade: insert, freeze, batched serving lookup, save and
    load, on ``device`` (default ``"cuda"``)."""

    #: maximum query tokens fed to the walk
    MAX_QUERY_TOKENS = 16

    def __init__(self, config: Optional[TrieConfig] = None, device: DeviceLike = None):
        self.config = config or TrieConfig()
        self.device = resolve_device(device)
        self._name_builder = TrieBuilder()
        self._content_builder = TrieBuilder()
        self._citation_builder = TrieBuilder()
        self._name: Optional[FrozenTrie] = None
        self._content: Optional[FrozenTrie] = None
        self._citation: Optional[FrozenTrie] = None
        self.content_window = self.config.content_window
        self.max_windows_per_paragraph = self.config.max_windows_per_paragraph
        #: set by load_from_disk: the builders are empty while the frozen
        #: tries hold content. The first insert rehydrates them; freeze()
        #: with no insert since keeps the loaded state
        self._builders_stale = False
        #: set by set_content_frozen: the content trie was built elsewhere
        #: and has no resident builder
        self._content_external = False

    def _ensure_builders(self) -> None:
        """Rehydrate the three builders from the loaded frozen tries before
        the first insert after ``load_from_disk``."""
        if not self._builders_stale:
            return
        self._name_builder = TrieBuilder.from_frozen(self._name)
        self._content_builder = TrieBuilder.from_frozen(self._content)
        self._citation_builder = TrieBuilder.from_frozen(self._citation)
        self._builders_stale = False

    def insert_case_name(self, case_name: str, case_row: int) -> None:
        if not self.config.index_case_names:
            return
        self._ensure_builders()
        self._name_builder.insert(word_tokens(case_name), case_row, 0)
        self._name = None

    def insert_content(self, tokens: Sequence[str], case_row: int, para_idx: int = 0) -> None:
        toks = word_tokens(" ".join(tokens))
        if not toks:
            return
        self._ensure_builders()
        if self._content_external:
            self._content_builder = TrieBuilder.from_frozen(self._content)
            self._content_external = False
        mode = self.config.content_windowing
        if mode == "all":
            starts = range(min(len(toks), self.max_windows_per_paragraph))
        else:
            starts = _phrase_start_positions(toks, mode)[: self.max_windows_per_paragraph]
        for s in starts:
            self._content_builder.insert(toks[s : s + self.content_window], case_row, para_idx)
        self._content = None

    def insert_citation(self, citation: str, case_row: int, para_idx: int = 0) -> None:
        if not self.config.index_citations:
            return
        self._ensure_builders()
        self._citation_builder.insert(citation.split(), case_row, para_idx)
        self._citation = None

    def freeze(self) -> None:
        """Compile the three tries; a no-op after a bare ``load_from_disk``
        (the loaded state is current)."""
        if self._builders_stale:
            return
        self._name = self._name_builder.freeze()
        if not self._content_external:
            self._content = self._content_builder.freeze()
        self._citation = self._citation_builder.freeze()

    def set_content_frozen(self, frozen: FrozenTrie) -> None:
        """Install a content trie built elsewhere: ``freeze()`` keeps it, and
        a later ``insert_content`` rehydrates the builder from it first."""
        self._content = frozen
        self._content_external = True

    @property
    def name_trie(self) -> FrozenTrie:
        if self._name is None:
            self._name = self._name_builder.freeze()
        return self._name

    @property
    def content_trie(self) -> FrozenTrie:
        if self._content is None:
            self._content = self._content_builder.freeze()
        return self._content

    @property
    def citation_trie(self) -> FrozenTrie:
        if self._citation is None:
            self._citation = self._citation_builder.freeze()
        return self._citation

    def search_batch_rows(
        self, queries: Sequence[str], max_postings: int = 64
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched lexical match for the hybrid step: case rows from the
        name and citation tries (exact) and the content trie (subtree),
        concatenated ``[B, 3*max_postings]`` (-1 padded) with a bool
        validity mask."""
        B = len(queries)
        Bpad = 1 if B <= 1 else max(8, 1 << (B - 1).bit_length())
        pad = [[] for _ in range(Bpad - B)]
        lower = [word_tokens(q) for q in queries] + pad
        raw = [q.split() for q in queries] + pad
        outs_r, outs_v = [], []
        for trie, toks, prefix in (
            (self.name_trie, lower, False),
            (self.citation_trie, raw, False),
            (self.content_trie, lower, True),
        ):
            ids = trie.encode_queries(toks, self.MAX_QUERY_TOKENS)
            _, r, v = trie.walk_and_gather(ids, self.device, max_postings, prefix)
            outs_r.append(r)
            outs_v.append(v)
        rows = torch.cat(outs_r, dim=1).to(torch.int32).cpu().numpy()
        valid = torch.cat(outs_v, dim=1).cpu().numpy()
        return rows[:B], valid[:B]

    def get_stats(self) -> dict:
        """Nodes, edges, postings and bytes of each of the three tries."""
        return {
            name: {
                "nodes": trie.num_nodes,
                "edges": trie.num_edges,
                "postings": trie.num_postings,
                "bytes": trie.nbytes(),
            }
            for name, trie in (
                ("name", self.name_trie),
                ("content", self.content_trie),
                ("citation", self.citation_trie),
            )
        }

    def get_completions(self, prefix: str, limit: int = 10) -> list[str]:
        out: list[str] = []
        for trie, toks in (
            (self.name_trie, word_tokens(prefix)),
            (self.citation_trie, prefix.split()),
            (self.content_trie, word_tokens(prefix)),
        ):
            if len(out) >= limit:
                break
            for c in trie.completions(toks, limit - len(out), self.config.max_prefix_length):
                if c not in out:
                    out.append(c)
        return out[:limit]

    def save_to_disk(self, path: Optional[str | Path] = None) -> None:
        base = Path(path or self.config.index_path)
        base.mkdir(parents=True, exist_ok=True)
        mm = self.config.enable_memory_mapping
        self.name_trie.save(base / "name_trie.npz", mmap_format=mm)
        self.content_trie.save(base / "content_trie.npz", mmap_format=mm)
        self.citation_trie.save(base / "citation_trie.npz", mmap_format=mm)

    @classmethod
    def load_from_disk(
        cls, path: str | Path, config: Optional[TrieConfig] = None,
        device: DeviceLike = None,
    ) -> "TrieIndex":
        base = Path(path)
        idx = cls(config, device=device)
        idx._name = FrozenTrie.load(base / "name_trie.npz")
        idx._content = FrozenTrie.load(base / "content_trie.npz")
        idx._citation = FrozenTrie.load(base / "citation_trie.npz")
        idx._builders_stale = True
        return idx
