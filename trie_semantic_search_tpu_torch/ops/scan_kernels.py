"""Hopper kernels of the search path, their plain versions and layouts.

Port of ``trie_semantic_search_tpu/ops/pallas_scan.py``. Each of its four
Pallas kernels became a CUDA C++ kernel for ``sm_90a`` under ``csrc/``:

==========================  ====================================  ======================
wrapper here                TPU kernel it replaces                source
==========================  ====================================  ======================
:func:`int8_topk`           ``pallas_int8_topk`` (:140-187)       ``csrc/int8_topk.cu``
:func:`fused_scan_topk`     ``pallas_fused_topk`` (:206-444)      ``csrc/fused_scan.cu``
:func:`probe_candidates`    ``pallas_probe_candidates`` (:447)    ``csrc/probe.cu``
:func:`gather_rescore_rows` ``pallas_gather_rescore`` (:636-809)  ``csrc/gather_rescore.cu``
==========================  ====================================  ======================

The last three run on the serving path; the first is reached only through
the public op :func:`fused_int8_topk`, as in the JAX package.

The int8 top-k and the fused scan have two variants each, picked by shape
(:func:`int8_topk_variant`, :func:`fused_scan_variant`): the products on
the int8 tensor cores (``wgmma``) where the shape fits, as ``__dp4a`` on
the CUDA cores elsewhere.

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version beside it (``*_plain``) for CPU tensors; there is no
fallback from a failed launch. ``nvcc`` builds the sources at first use,
one process per source, into one shared library with a plain C interface
(:func:`load_library`). Every launch adds one to :data:`LAUNCHES`.

The plain versions are the reference the kernels are held against: the
int8 products run as f32 matrix products of int8 values over parts of K of
at most 1,024 (:func:`int8_products`; each part's sums stay within 2^24,
so each is exact provided TF32 is off, which :func:`exact_float32` sets),
the parts added exactly in f64 and rounded once to f32, as the kernels
round their int32 sums: exact at every width.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .topk import topk_by_score_then_row

#: corpus rows per tile of the fused scan (the TPU kernel's block size; it
#: sets the divisibility rule and the cap on the per-lane list length)
TILE_N = 2048
#: tile for corpora of at least ``_BIG_N`` rows that divide by it
TILE_N_BIG = 8192
_BIG_N = 1 << 22
#: queries per tile of the fused scan on the TPU; the serving thresholds
#: (stream break-even, escalation bucket) are expressed in it
TILE_B = 256
#: lane families of the int8 scans: a row's lane is ``row % LANES``
LANES = 128


def auto_tile_n(n: int) -> int:
    """Tile size for an ``n``-row corpus (``TILE_N_BIG`` when big enough
    and divisible, else ``TILE_N``). Results do not depend on it beyond the
    cap it puts on the lane list length."""
    if n >= _BIG_N and n % TILE_N_BIG == 0:
        return TILE_N_BIG
    return TILE_N


def pad_align_for(n: int) -> int:
    """Row alignment a brute-mode corpus of ``n`` rows pads to."""
    return TILE_N_BIG if n >= _BIG_N else TILE_N


#: bf16 rescore stores split into row segments under this size (the JAX
#: package's artifact layout; the kernel here takes any segment count)
GATHER_SEG_BYTES = 1 << 31
#: every segment's row count is a multiple of this (tail zero-padded)
GATHER_ROW_ALIGN_LCM = 32

#: launches of each kernel since the last :func:`reset_launch_counts`
#: (``int8_topk`` and ``fused_scan`` are the tensor-core variants of the
#: int8 top-k and the fused scan, ``int8_topk_dp4a`` and ``fused_scan_dp4a``
#: their variants for the shapes those do not take)
LAUNCHES = {"int8_topk": 0, "int8_topk_dp4a": 0, "fused_scan": 0, "fused_scan_dp4a": 0,
            "probe_candidates": 0, "gather_rescore": 0}


_launch_lock = threading.Lock()


def _count_launch(name: str) -> None:
    """One launch of ``name``: under a lock, since the server's batch
    workers launch from two threads at once."""
    with _launch_lock:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def exact_float32() -> None:
    """Turn TF32 off for float32 products on the card, so an f32 product of
    int8 values is exact and f32 reference products keep full precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


#: widest part of K whose int8 products an f32 sum holds exactly
#: (1,024 × 128² = 2^24)
EXACT_K = 1024


def int8_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (int8 values, any real dtype, ``b`` ``[..., K, N]``) as
    f32: the exact integer sums rounded once to f32. Parts of K of at
    most :data:`EXACT_K` are exact f32 products (TF32 off); where there
    are several they are added in f64, exact too."""
    K = a.shape[-1]
    a, b = a.to(torch.float32), b.to(torch.float32)
    if K <= EXACT_K:
        return a @ b
    out = None
    for k0 in range(0, K, EXACT_K):
        part = (a[..., k0 : k0 + EXACT_K] @ b[..., k0 : k0 + EXACT_K, :]).to(torch.float64)
        out = part if out is None else out + part
    return out.to(torch.float32)


# ---------------------------------------------------------------------------
# Layouts shared by the kernels and their plain versions
# ---------------------------------------------------------------------------


def _bits_to_int32(words: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 → int32 with the same bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_court_words(court_table: torch.Tensor) -> torch.Tensor:
    """``[B, V]`` bool allowed-court table → ``[B, W]`` bitmask words
    (``W = ceil(V/32)``; court ``c`` is bit ``c % 32`` of word ``c // 32``)
    as int32 bit patterns (the JAX function returns the same bits as
    uint32)."""
    B, V = court_table.shape
    W = max(1, -(-V // 32))
    ct = torch.zeros((B, W * 32), dtype=torch.int64, device=court_table.device)
    ct[:, :V] = court_table.to(torch.int64)
    shifts = torch.arange(32, device=court_table.device, dtype=torch.int64)
    words = (ct.view(B, W, 32) << shifts).sum(dim=-1)
    return _bits_to_int32(words)


def court_word_bit(court: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row court id → (word index ``court // 32``, bit pattern
    ``1 << (court % 32)`` as int32), floor semantics for negative ids as
    the JAX wrapper has them."""
    c = court.to(torch.int64)
    word = torch.div(c, 32, rounding_mode="floor").to(torch.int32)
    bit = _bits_to_int32(torch.ones_like(c) << torch.remainder(c, 32))
    return word, bit


def partition_filter_columns(
    part_rows, chunk_court, chunk_date
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partition-major filter columns for the probe kernel (host numpy, once
    per index): court word, court bit (int32 bit pattern) and date per
    slot. Pad slots get word -1 and the int32 minimum date so no filter
    passes."""
    rows = np.asarray(part_rows)
    court = np.asarray(chunk_court)
    date = np.asarray(chunk_date)
    safe = np.maximum(rows, 0)
    pc = court[safe].astype(np.int32)
    pd = date[safe].astype(np.int32)
    cword = (pc // 32).astype(np.int32)
    cbit = (np.uint32(1) << (pc.astype(np.uint32) % 32)).view(np.int32)
    pad = rows < 0
    cword[pad] = -1
    pd[pad] = np.iinfo(np.int32).min
    return cword, cbit, pd


def split_rescore_corpus(v, to_device=None) -> tuple:
    """Split an ``[N, D]`` numpy rescore corpus into row segments
    under :data:`GATHER_SEG_BYTES`, each a multiple of
    :data:`GATHER_ROW_ALIGN_LCM` rows (the tail zero-pads) — the JAX
    package's saved layout. ``to_device`` maps each segment (split first,
    so the host holds one segment at a time)."""
    n, d = v.shape
    itemsize = np.dtype(v.dtype).itemsize
    L = GATHER_ROW_ALIGN_LCM
    rows = max(L, (GATHER_SEG_BYTES // max(d * itemsize, 1)) // L * L)
    if to_device is None:
        to_device = lambda x: x  # noqa: E731

    def _seg(lo: int):
        seg = v[lo : min(lo + rows, n)]
        r = int(seg.shape[0]) % L
        if r:
            seg = np.concatenate([seg, np.zeros((L - r, d), seg.dtype)])
        return seg

    return tuple(to_device(_seg(lo)) for lo in range(0, max(n, 1), rows))


# ---------------------------------------------------------------------------
# Kernel library: built from csrc/ with nvcc at first use, bound with ctypes
# ---------------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("int8_topk.cu", "fused_scan.cu", "probe.cu", "gather_rescore.cu")
_HEADERS = ("common.cuh",)
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_CFLAGS = _ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib_lock = threading.Lock()
_library: Optional["KernelLibrary"] = None


class KernelLibrary:
    """The loaded shared library plus how it was built."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        #: compiler output (``-Xptxas -v``: registers, shared memory, spills)
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        for fn in (self.lib.tss_int8_topk, self.lib.tss_int8_topk_dp4a):
            fn.argtypes = [P] * 9 + [I] * 6 + [P]
            fn.restype = I
        self.lib.tss_int8_topk_block_queries.argtypes = [I, I, I]
        self.lib.tss_int8_topk_block_queries.restype = I
        self.lib.tss_fused_scan_wgmma.argtypes = [P] * 13 + [I] * 6 + [P]
        self.lib.tss_fused_scan_wgmma.restype = I
        self.lib.tss_fused_scan_dp4a.argtypes = [P] * 13 + [I] * 6 + [P]
        self.lib.tss_fused_scan_dp4a.restype = I
        self.lib.tss_fused_scan_dp4a_smem_bytes.argtypes = [I, I]
        self.lib.tss_fused_scan_dp4a_smem_bytes.restype = S
        self.lib.tss_probe_candidates.argtypes = [P] * 16 + [I] * 7 + [P]
        self.lib.tss_probe_candidates.restype = I
        self.lib.tss_probe_group_size.argtypes = []
        self.lib.tss_probe_group_size.restype = I
        if self.lib.tss_probe_group_size() != PROBE_GROUP:
            raise RuntimeError("csrc/probe.cu and PROBE_GROUP disagree on the work group size")
        self.lib.tss_gather_rescore.argtypes = [P, P, P, I, P, P, I, I, I, P]
        self.lib.tss_gather_rescore.restype = I


def build_dir() -> Path:
    """Where the library is built: ``$TSS_TORCH_BUILD_DIR`` or ``_build``
    inside the package (listed in ``.gitignore``)."""
    env = os.environ.get("TSS_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parent.parent / "_build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def load_library(defines: tuple[str, ...] = ()) -> KernelLibrary:
    """Build (once per source digest) and load the kernel library. Each
    source compiles in its own ``nvcc`` process, all started together, and
    one more ``nvcc`` links the objects. ``defines`` (``NAME=VALUE``) build
    a separate library for measurement (``chip_smoke.py``'s ablations); it
    is returned, and the wrappers keep launching the plain build."""
    global _library
    flags = _CFLAGS + [f"-D{d}" for d in defines]
    with _lib_lock:
        if _library is not None and not defines:
            return _library
        h = hashlib.sha256(" ".join(flags).encode())
        for name in _SOURCES + _HEADERS:
            h.update((_CSRC / name).read_bytes())
        digest = h.hexdigest()[:16]
        out = build_dir() / digest
        so = out / "libtss_kernels.so"
        log_path = out / "build.log"
        t0 = time.perf_counter()
        if not so.exists():
            out.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = []
            for name in _SOURCES:
                obj = out / (name + ".o")
                cmd = [nvcc, *flags, "-c", str(_CSRC / name), "-o", str(obj)]
                procs.append((name, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                )))
            logs = []
            failed = []
            for name, _, p in procs:
                text, _ = p.communicate()
                logs.append(f"== {name}\n{text}")
                if p.returncode != 0:
                    failed.append(name)
            if failed:
                raise RuntimeError(
                    f"nvcc failed for {failed}:\n" + "\n".join(logs)
                )
            tmp = out / f"libtss_kernels.{os.getpid()}.so"
            link = subprocess.run(
                [nvcc, *_ARCH, "-shared", "-o", str(tmp),
                 *[str(obj) for _, obj, _ in procs]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
            os.replace(tmp, so)
            log_path.write_text("\n".join(logs))
        log = log_path.read_text() if log_path.exists() else ""
        lib = KernelLibrary(so, time.perf_counter() - t0, log)
        if not defines:
            _library = lib
        return lib


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with cudaError_t {err}")


# ---------------------------------------------------------------------------
# 0. Unfiltered int8 scan with an exact top-k (pallas_int8_topk)
# ---------------------------------------------------------------------------

#: largest k of :func:`int8_topk` (the engine's largest k bucket)
INT8_TOPK_MAX_K = 128
#: corpus rows the plain version scores at a time (bounds its ``[B, rows]``
#: score block)
INT8_TOPK_PLAIN_CHUNK = 1 << 18
#: widest row (D, bytes) the tensor-core variant of the int8 top-k takes;
#: its rows are whole k32 steps (D % 32 == 0)
INT8_TOPK_WGMMA_MAX_D = 512
#: corpus rows per TMA tile of the tensor-core variant (its row ranges are
#: whole tiles)
INT8_TOPK_WGMMA_ROWS = 128


def int8_topk_plain(
    q8, q_scale, corpus_q, corpus_scale, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the int8 top-k kernel: ``score = (f32(q8·row) *
    q_scale) * row_scale`` and, per query, the k best rows by (score desc,
    row asc) with floats compared as ``>``/``==`` (``+0.0 == -0.0``, so the
    lower row wins), over row chunks with a running list.

    Output values are the Pallas kernel's: it writes each round's maximum,
    which is ``+0.0`` for a zero whenever a ``+0.0`` row lies at or after
    the selected row, so a ``-0.0`` row before the last ``+0.0`` row of its
    query reads ``+0.0``."""
    exact_float32()
    B = q8.shape[0]
    N = corpus_q.shape[0]
    dev = q8.device
    qf = q8.to(torch.float32)
    qs = q_scale.reshape(B, 1).to(torch.float32)
    cs = corpus_scale.reshape(N).to(torch.float32)
    run_v = torch.empty((B, 0), dtype=torch.float32, device=dev)
    run_i = torch.empty((B, 0), dtype=torch.int64, device=dev)
    last_pos_zero = torch.full((B,), -1, dtype=torch.int64, device=dev)
    for lo in range(0, N, INT8_TOPK_PLAIN_CHUNK):
        hi = min(lo + INT8_TOPK_PLAIN_CHUNK, N)
        s = int8_products(qf, corpus_q[lo:hi].T) * qs * cs[lo:hi].reshape(1, -1)
        rows = torch.arange(lo, hi, device=dev).expand(B, -1)
        pos_zero = (s == 0) & ~torch.signbit(s)
        last_pos_zero = torch.maximum(
            last_pos_zero, torch.where(pos_zero, rows, -1).amax(dim=1)
        )
        v = torch.cat([run_v, s], dim=1)
        i = torch.cat([run_i, rows], dim=1)
        # + 0.0 turns -0.0 into +0.0, so zeros tie; the stable sort keeps
        # the running rows (lower) and then this chunk's in row order
        order = torch.sort(-(v + 0.0), dim=1, stable=True).indices[:, :k]
        run_v, run_i = torch.gather(v, 1, order), torch.gather(i, 1, order)
    signed_zero = (run_v == 0) & (run_i <= last_pos_zero[:, None])
    run_v = torch.where(signed_zero, torch.zeros_like(run_v), run_v)
    return run_v, run_i.to(torch.int32)


def int8_topk_variant(D: int, k: int) -> str:
    """The CUDA int8 top-k's variant for rows of D bytes and lists of k:
    ``"wgmma"`` (tensor cores) for D a multiple of 32 up to 512 bytes,
    ``"dp4a"`` for any other D (k up to 128 in both)."""
    if D % 32 == 0 and 32 <= D <= INT8_TOPK_WGMMA_MAX_D and k <= INT8_TOPK_MAX_K:
        return "wgmma"
    return "dp4a"


def int8_topk_cuda(
    q8, q_scale, corpus_q, corpus_scale, k: int, variant: Optional[str] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/int8_topk.cu``: ``q8 [B, D]`` int8, ``q_scale [B]``
    f32, ``corpus_q [N, D]`` int8, ``corpus_scale [N]`` f32 → ``([B, k]
    values, [B, k] rows)``, the contract of :func:`int8_topk_plain`, by the
    variant :func:`int8_topk_variant` picks, or by ``variant`` where the
    caller names one (the dp4a variant takes every shape). The wrapper
    :func:`int8_topk` checks dtypes, shapes and k."""
    dev = q8.device
    B, D = q8.shape
    N = corpus_q.shape[0]
    for t in (q_scale, corpus_q, corpus_scale):
        if t.device != dev:
            raise ValueError(f"int8 top-k inputs lie on {t.device} and {dev}")
    if D % 16 or q8.data_ptr() % 16 or corpus_q.data_ptr() % 16:
        raise ValueError(f"int8 top-k kernel needs D % 16 == 0 and 16-byte aligned rows, got D={D}")
    variant = variant or int8_topk_variant(D, k)
    if variant not in ("wgmma", "dp4a") or (variant == "wgmma" and int8_topk_variant(D, k) != variant):
        raise ValueError(f"int8 top-k variant {variant!r} does not take D={D}")
    if variant == "wgmma" and corpus_scale.data_ptr() % 16:
        raise ValueError("the int8 top-k's wgmma variant needs 16-byte aligned row scales")
    lib = load_library()
    if variant == "wgmma":
        # one block per SM: (query tile, row range) blocks, whole 128-row
        # tiles per range
        q_tiles = -(-B // lib.lib.tss_int8_topk_block_queries(B, D, k))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        align = INT8_TOPK_WGMMA_ROWS
        n_ranges = max(1, min(-(-N // align), sms // q_tiles, 65535))
    else:
        # about eight blocks of (8 queries, row range) per SM of 132, whole
        # 256-row chunks per range
        q_tiles = -(-B // 8)
        align = 256
        n_ranges = max(1, min(-(-N // 256), -(-1056 // q_tiles), 65535))
    rows_per_range = -(-(-(-N // n_ranges)) // align) * align
    n_ranges = -(-N // rows_per_range)
    part_v = torch.empty((n_ranges, B, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_ranges, B, k), dtype=torch.int32, device=dev)
    part_z = torch.empty((n_ranges, B), dtype=torch.int32, device=dev)
    out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    args = (
        _ptr(q8), _ptr(q_scale), _ptr(corpus_q), _ptr(corpus_scale),
        _ptr(part_v), _ptr(part_i), _ptr(part_z), _ptr(out_v), _ptr(out_i),
        B, D, N, k, n_ranges, rows_per_range, _stream(dev),
    )
    if variant == "wgmma":
        _raise_on(lib.lib.tss_int8_topk(*args), "int8 top-k kernel")
        _count_launch("int8_topk")
    else:
        _raise_on(lib.lib.tss_int8_topk_dp4a(*args), "int8 top-k kernel (dp4a)")
        _count_launch("int8_topk_dp4a")
    return out_v, out_i


def int8_topk(
    q8: torch.Tensor,  # [B, D] int8
    q_scale: torch.Tensor,  # [B, 1] f32
    corpus_q: torch.Tensor,  # [N, D] int8, any N
    corpus_scale: torch.Tensor,  # [N, 1] f32
    k: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Port of ``pallas_int8_topk`` → ``([B, k] f32, [B, k] int32)``: the
    kernel for CUDA tensors, the plain version for CPU tensors. Equal
    scores go to the lower row, ``+0.0 == -0.0`` included, as in the
    Pallas kernel (``lax.top_k`` ranks ``+0.0`` first: see
    :func:`xla_int8_topk`)."""
    if q8.dtype != torch.int8 or corpus_q.dtype != torch.int8:
        raise TypeError(f"q8 and corpus_q must be int8, got {q8.dtype} and {corpus_q.dtype}")
    if q_scale.dtype != torch.float32 or corpus_scale.dtype != torch.float32:
        raise TypeError("q_scale and corpus_scale must be float32")
    if q8.dim() != 2 or corpus_q.dim() != 2 or q8.shape[1] != corpus_q.shape[1]:
        raise ValueError(f"shapes {tuple(q8.shape)} and {tuple(corpus_q.shape)} are not [B, D] and [N, D]")
    B, N = q8.shape[0], corpus_q.shape[0]
    if q_scale.numel() != B or corpus_scale.numel() != N:
        raise ValueError("q_scale must hold one scale per query and corpus_scale one per row")
    if not 1 <= k <= min(N, INT8_TOPK_MAX_K):
        raise ValueError(f"k={k} must lie in [1, min(N={N}, {INT8_TOPK_MAX_K})]")
    if q8.is_cuda:
        return int8_topk_cuda(
            q8.contiguous(), q_scale.reshape(B).contiguous(), corpus_q.contiguous(),
            corpus_scale.reshape(N).contiguous(), k,
        )
    return int8_topk_plain(q8, q_scale, corpus_q, corpus_scale, k)


def xla_int8_topk(q8, q_scale, corpus_q, corpus_scale, k: int = 10):
    """Port of ``xla_int8_topk``: the whole ``[B, N]`` score matrix, then a
    top-k in ``lax.top_k``'s order (``+0.0`` above ``-0.0``)."""
    from .topk import exact_topk

    exact_float32()
    B, N = q8.shape[0], corpus_q.shape[0]
    s = (q8.to(torch.float32) @ corpus_q.to(torch.float32).T) * q_scale.reshape(B, 1).to(
        torch.float32
    ) * corpus_scale.reshape(1, N).to(torch.float32)
    v, i = exact_topk(s, k)
    return v, i.to(torch.int32)


def fused_int8_topk(q8, q_scale, corpus_q, corpus_scale, k: int = 10):
    """Port of the public op ``fused_int8_topk``: the scan that keeps the
    ``[B, N]`` scores out of device memory (:func:`int8_topk`), at any N.
    On the accelerator the JAX op returns the Pallas kernel's result, whose
    tie order this follows."""
    return int8_topk(q8, q_scale, corpus_q, corpus_scale, k)


# ---------------------------------------------------------------------------
# 1. Fused filtered scan (pallas_fused_topk)
# ---------------------------------------------------------------------------


def fused_scan_n_keep(k: int, tile_n: int, lanes: int = LANES) -> int:
    """Lane list length T: enough slots for k plus one collision layer."""
    return min(max(2, -(-k // lanes) + 1), tile_n // lanes)


def fused_scan_plain(
    q8, q_scale, qwords, dlo, dhi, mins, corpus_q, corpus_scale, cword,
    cbit, cdate, n_keep: int, use_court: bool, use_date: bool,
    lanes: int = LANES,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused-scan kernel on the prepared inputs
    (``q_scale/dlo/dhi/mins [B]`` f32, ``qwords [B, W]`` int32,
    ``corpus_scale/cdate [N]`` f32, ``cword/cbit [N]`` int32) →
    ``([B, T*lanes] values, rows)``, element ``t*lanes + l`` slot t of lane
    ``l``'s list; dead ``(-inf, -1)``.

    The TPU kernel's list update, row block by row block: each lane's
    scores bubble in ascending row order into T slots with a strict ``>``.
    It is not a top-T by (score desc, row asc): a tied entry carried down
    by a higher score does not pass its equal, so the lower row drops."""
    exact_float32()
    B = q8.shape[0]
    N = corpus_q.shape[0]
    acc = int8_products(q8, corpus_q.T)
    s = acc * q_scale.reshape(B, 1) * corpus_scale.reshape(1, N)
    keep = s >= mins.reshape(B, 1)
    if use_court:
        W = qwords.shape[1]
        cw = cword.to(torch.int64)
        qw = qwords[:, torch.clamp(cw, 0, W - 1)]  # [B, N]
        keep &= ((cw >= 0) & (cw < W)).reshape(1, N) & ((qw & cbit.reshape(1, N)) != 0)
    if use_date:
        keep &= (cdate.reshape(1, N) >= dlo.reshape(B, 1)) & (
            cdate.reshape(1, N) <= dhi.reshape(B, 1)
        )
    s = torch.where(keep, s, torch.full_like(s, -float("inf"))).reshape(B, N // lanes, lanes)
    v = [torch.full((B, lanes), -float("inf"), device=s.device) for _ in range(n_keep)]
    ix = [torch.full((B, lanes), -1, dtype=torch.int32, device=s.device) for _ in range(n_keep)]
    lane = torch.arange(lanes, dtype=torch.int32, device=s.device).expand(B, lanes)
    for j in range(N // lanes):
        sj, rj = s[:, j], lane + j * lanes
        for t in range(n_keep):
            gt = sj > v[t]
            v[t], sj = torch.where(gt, sj, v[t]), torch.where(gt, v[t], sj)
            ix[t], rj = torch.where(gt, rj, ix[t]), torch.where(gt, ix[t], rj)
    return torch.cat(v, dim=1), torch.cat(ix, dim=1)


#: longest lane list (T) and widest row (D, bytes) the tensor-core
#: variant of the fused scan takes; beyond either the dp4a variant runs
FUSED_SCAN_WGMMA_MAX_T = 16
FUSED_SCAN_WGMMA_MAX_D = 2048


def fused_scan_variant(D: int, n_keep: int) -> str:
    """The CUDA fused scan's variant for rows of D bytes and lane lists of
    length ``n_keep``: ``"wgmma"`` (tensor cores) up to 16 slots and 2048
    bytes, ``"dp4a"`` beyond either."""
    if n_keep <= FUSED_SCAN_WGMMA_MAX_T and D <= FUSED_SCAN_WGMMA_MAX_D:
        return "wgmma"
    return "dp4a"


def fused_scan_cuda(
    q8, q_scale, qwords, dlo, dhi, mins, corpus_q, corpus_scale, cword,
    cbit, cdate, n_keep: int, use_court: bool, use_date: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/fused_scan.cu`` on the prepared inputs (same contract
    as :func:`fused_scan_plain`, lanes fixed at 128), the variant
    :func:`fused_scan_variant` picks."""
    dev = q8.device
    B, D = q8.shape
    N = corpus_q.shape[0]
    W = qwords.shape[1]
    f32, i32 = torch.float32, torch.int32
    _check(q8, "q8", torch.int8, (B, D), dev)
    _check(corpus_q, "corpus_q", torch.int8, (N, D), dev)
    for t, name in ((q_scale, "q_scale"), (dlo, "date_lo"), (dhi, "date_hi"),
                    (mins, "min_sim")):
        _check(t, name, f32, (B,), dev)
    _check(qwords, "qwords", i32, (B, W), dev)
    _check(corpus_scale, "corpus_scale", f32, (N,), dev)
    _check(cword, "cword", i32, (N,), dev)
    _check(cbit, "cbit", i32, (N,), dev)
    _check(cdate, "cdate", f32, (N,), dev)
    if D % 16 or N % LANES or not N or any(
        t.data_ptr() % 16 for t in (q8, corpus_q, corpus_scale, cword, cbit, cdate)
    ):
        raise ValueError(f"fused scan needs D % 16 == 0, N % 128 == 0 and 16-byte aligned "
                         f"rows and columns, got D={D} N={N}")
    variant = fused_scan_variant(D, n_keep)
    lib = load_library()
    if variant == "dp4a" and (
        n_keep > 64 or lib.lib.tss_fused_scan_dp4a_smem_bytes(D, n_keep) > 232_448
    ):
        raise ValueError(f"lane list length {n_keep} too long for the kernel")
    out_v = torch.empty((B, n_keep * LANES), dtype=f32, device=dev)
    out_i = torch.empty((B, n_keep * LANES), dtype=i32, device=dev)
    args = (
        _ptr(q8), _ptr(q_scale), _ptr(qwords), _ptr(dlo), _ptr(dhi), _ptr(mins),
        _ptr(corpus_q), _ptr(corpus_scale), _ptr(cword), _ptr(cbit), _ptr(cdate),
        _ptr(out_v), _ptr(out_i), B, D, N, W if use_court else 0, int(use_date), n_keep,
        _stream(dev),
    )
    if variant == "wgmma":
        _raise_on(lib.lib.tss_fused_scan_wgmma(*args), "fused scan kernel")
        _count_launch("fused_scan")
    else:
        _raise_on(lib.lib.tss_fused_scan_dp4a(*args), "fused scan kernel (dp4a)")
        _count_launch("fused_scan_dp4a")
    return out_v, out_i


def fused_scan_query_inputs(q_scale, court_table, date_lo, date_hi, min_sim) -> dict:
    """The kernel's per-query inputs (``q_scale, qwords, dlo, dhi, mins``)
    from the serving arrays: the same for every slab of a batch."""
    B = court_table.shape[0]
    f32 = torch.float32
    return dict(
        q_scale=q_scale.to(f32).reshape(B).contiguous(),
        qwords=pack_court_words(court_table).contiguous(),
        dlo=date_lo.to(f32).reshape(B).contiguous(),
        dhi=date_hi.to(f32).reshape(B).contiguous(),
        mins=min_sim.to(f32).reshape(B).contiguous(),
    )


def fused_scan_row_inputs(chunk_court, chunk_date, corpus_scale) -> dict:
    """The kernel's per-row inputs (``corpus_scale, cword, cbit, cdate``);
    those of a row range are the same slice of those of the whole corpus."""
    cword, cbit = court_word_bit(chunk_court)
    return dict(
        corpus_scale=corpus_scale.to(torch.float32).reshape(-1).contiguous(),
        cword=cword.contiguous(),
        cbit=cbit.contiguous(),
        cdate=chunk_date.to(torch.float32).reshape(-1).contiguous(),
    )


def fused_scan_inputs(
    q_scale, chunk_court, chunk_date, court_table, date_lo, date_hi, min_sim,
    corpus_scale,
) -> dict:
    """The kernel's per-query and per-row inputs from the serving arrays
    (the conversions the TPU wrapper does before its ``pallas_call``)."""
    return {
        **fused_scan_query_inputs(q_scale, court_table, date_lo, date_hi, min_sim),
        **fused_scan_row_inputs(chunk_court, chunk_date, corpus_scale),
    }


def fused_scan_topk(
    q8: torch.Tensor,  # [B, D] int8 quantised queries
    q_scale: torch.Tensor,  # [B, 1] f32
    corpus_q: torch.Tensor,  # [N, D] int8 (N % tile_n == 0)
    corpus_scale: torch.Tensor,  # [N, 1] f32
    chunk_court: torch.Tensor,  # [N] int32
    chunk_date: torch.Tensor,  # [N] int32
    court_table: torch.Tensor,  # [B, V] bool
    date_lo: torch.Tensor,  # [B] int32
    date_hi: torch.Tensor,  # [B] int32
    min_sim: torch.Tensor,  # [B] f32
    k: int,
    tile_n: Optional[int] = None,
    lanes: int = LANES,
    use_court: bool = True,
    use_date: bool = True,
    prepared: Optional[dict] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Port of ``pallas_fused_topk``: filtered int8 scan → top-T per lane
    (kernel on CUDA, plain version on the CPU) → composite (score, row)
    top-k. Returns ``(values, rows) [B, k]``, dead slots ``(-inf, -1)``.

    ``prepared`` holds the kernel inputs already made from these arrays
    (:func:`fused_scan_inputs`, or its query part for the batch and a
    slice of its row part); the arrays it replaces are then not read."""
    N = corpus_q.shape[0]
    if tile_n is None:
        tile_n = auto_tile_n(N)
    if N % tile_n or tile_n % lanes:
        raise ValueError(f"N={N} must divide by tile_n={tile_n}, tile_n by lanes={lanes}")
    n_keep = fused_scan_n_keep(k, tile_n, lanes)
    inp = prepared if prepared is not None else fused_scan_inputs(
        q_scale, chunk_court, chunk_date, court_table, date_lo, date_hi,
        min_sim, corpus_scale,
    )
    if q8.is_cuda:
        if lanes != LANES:
            raise ValueError("the CUDA fused scan runs 128 lanes")
        out_v, out_i = fused_scan_cuda(
            q8.contiguous(), corpus_q=corpus_q.contiguous(), n_keep=n_keep,
            use_court=use_court, use_date=use_date, **inp,
        )
    else:
        out_v, out_i = fused_scan_plain(
            q8, corpus_q=corpus_q, n_keep=n_keep, use_court=use_court,
            use_date=use_date, lanes=lanes, **inp,
        )
    v, i = topk_by_score_then_row(out_v, out_i, min(k, out_v.shape[1]))
    return v, torch.where(torch.isneginf(v), torch.full_like(i, -1), i)


# ---------------------------------------------------------------------------
# 2. Probe scan (pallas_probe_candidates)
# ---------------------------------------------------------------------------


def probe_candidates_plain(
    q8, q_scale, top_p, part_int8, part_scale, part_rows, part_cword,
    part_cbit, part_date, qwords, date_lo, date_hi, min_sim, lanes: int = LANES,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the probe kernel → ``(values, slots)`` each
    ``[B, NP*2*lanes]`` (probe-major, then rank, then lane), with the TPU
    kernel's top-2-per-lane update rule over the ``m/lanes`` sub-blocks."""
    exact_float32()
    B, NP = top_p.shape
    m = part_scale.shape[1]
    W = qwords.shape[1]
    nb = m // lanes
    q = q8.to(torch.float32)
    qs = q_scale.reshape(B, 1).to(torch.float32)
    lo = date_lo.reshape(B, 1)
    hi = date_hi.reshape(B, 1)
    ms = min_sim.reshape(B, 1).to(torch.float32)
    lane = torch.arange(lanes, device=q8.device, dtype=torch.int32)
    out_v = torch.empty((B, NP, 2, lanes), dtype=torch.float32, device=q8.device)
    out_s = torch.empty((B, NP, 2, lanes), dtype=torch.int32, device=q8.device)
    ninf = -float("inf")
    for p in range(NP):
        pid = top_p[:, p].long()
        acc = int8_products(q[:, None, :], part_int8[pid].transpose(1, 2))[:, 0]
        s = acc * qs * part_scale[pid]
        cw = part_cword[pid].to(torch.int64)
        qw = torch.gather(qwords, 1, torch.clamp(cw, 0, W - 1))
        court_ok = (cw >= 0) & (cw < W) & ((qw & part_cbit[pid]) != 0)
        dts = part_date[pid]
        keep = court_ok & (dts >= lo) & (dts <= hi) & (part_rows[pid] >= 0) & (s >= ms)
        s = torch.where(keep, s, torch.full_like(s, ninf)).reshape(B, nb, lanes)
        v1 = s[:, 0]
        j1 = torch.zeros((B, lanes), dtype=torch.int32, device=q8.device)
        v2 = torch.full_like(v1, ninf)
        j2 = torch.zeros_like(j1)
        for j in range(1, nb):
            sj = s[:, j]
            gt1 = sj > v1
            c2v = torch.where(gt1, v1, sj)
            c2j = torch.where(gt1, j1, torch.full_like(j1, j))
            v1 = torch.where(gt1, sj, v1)
            j1 = torch.where(gt1, torch.full_like(j1, j), j1)
            gt2 = c2v > v2
            v2 = torch.where(gt2, c2v, v2)
            j2 = torch.where(gt2, c2j, j2)
        out_v[:, p, 0], out_v[:, p, 1] = v1, v2
        out_s[:, p, 0], out_s[:, p, 1] = j1 * lanes + lane, j2 * lanes + lane
    return out_v.reshape(B, -1), out_s.reshape(B, -1)


#: queries per work group of the CUDA probe (``G`` in ``csrc/probe.cu``)
PROBE_GROUP = 8


def probe_max_groups(B: int, NP: int, P: int) -> int:
    """Most work groups the CUDA probe's plan can make from ``B*NP``
    (query, probe) pairs over ``P`` partitions: a partition probed ``c``
    times makes ``ceil(c/G) <= 1 + (c-1)//G`` groups (``G =``
    :data:`PROBE_GROUP`), at most ``min(P, B*NP)`` partitions are probed
    and the ``c - 1`` sum to at most ``B*NP``."""
    n = B * NP
    return min(P, n) + n // PROBE_GROUP


def probe_scratch_ints(B: int, NP: int, P: int) -> int:
    """int32 scratch of the CUDA probe: the groups (4 ints each), 4 ints
    of counters, one count per partition and one entry per pair."""
    return 4 * probe_max_groups(B, NP, P) + 4 + P + B * NP


def probe_candidates_cuda(
    q8, q_scale, top_p, part_int8, part_scale, part_rows, part_cword,
    part_cbit, part_date, qwords, date_lo, date_hi, min_sim,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/probe.cu`` (same contract as
    :func:`probe_candidates_plain`, lanes fixed at 128): one C call that
    groups the pairs by partition on the card and scans each probed
    partition once per group of up to :data:`PROBE_GROUP` of its queries."""
    dev = q8.device
    B, D = q8.shape
    NP = top_p.shape[1]
    P, m = part_scale.shape
    W = qwords.shape[1]
    f32, i32 = torch.float32, torch.int32
    _check(q8, "q8", torch.int8, (B, D), dev)
    _check(q_scale, "q_scale", f32, (B,), dev)
    _check(top_p, "top_p", i32, (B, NP), dev)
    _check(part_int8, "part_int8", torch.int8, (P, m, D), dev)
    _check(part_scale, "part_scale", f32, (P, m), dev)
    for t, name in ((part_rows, "part_rows"), (part_cword, "part_cword"),
                    (part_cbit, "part_cbit"), (part_date, "part_date")):
        _check(t, name, i32, (P, m), dev)
    _check(qwords, "qwords", i32, (B, W), dev)
    _check(date_lo, "date_lo", i32, (B,), dev)
    _check(date_hi, "date_hi", i32, (B,), dev)
    _check(min_sim, "min_sim", f32, (B,), dev)
    if D % 16 or m % LANES or not P or any(
        t.data_ptr() % 16 for t in (q8, part_int8, part_scale, part_rows, part_cword, part_cbit,
                                    part_date)
    ):
        raise ValueError(f"probe kernel needs D % 16 == 0, m % 128 == 0 and 16-byte aligned "
                         f"rows and columns, got D={D} m={m} P={P}")
    lib = load_library()
    out_v = torch.empty((B, NP * 2 * LANES), dtype=f32, device=dev)
    out_s = torch.empty((B, NP * 2 * LANES), dtype=i32, device=dev)
    if B and NP:
        scratch = torch.empty(probe_scratch_ints(B, NP, P), dtype=i32, device=dev)
        err = lib.lib.tss_probe_candidates(
            _ptr(q8), _ptr(q_scale), _ptr(top_p), _ptr(part_int8),
            _ptr(part_scale), _ptr(part_rows), _ptr(part_cword), _ptr(part_cbit),
            _ptr(part_date), _ptr(qwords), _ptr(date_lo), _ptr(date_hi),
            _ptr(min_sim), _ptr(out_v), _ptr(out_s), _ptr(scratch),
            probe_max_groups(B, NP, P), B, NP, P, m, D, W, _stream(dev),
        )
        _raise_on(err, "probe kernel")
        _count_launch("probe_candidates")
    return out_v, out_s


def probe_candidates(
    q8: torch.Tensor,  # [B, D] int8
    q_scale: torch.Tensor,  # [B, 1] f32
    top_p: torch.Tensor,  # [B, NP] int probed partition ids
    part_int8: torch.Tensor,  # [P, m, D] int8
    part_scale: torch.Tensor,  # [P, m] f32
    part_rows: torch.Tensor,  # [P, m] int32 (-1 pad)
    part_cword: torch.Tensor,  # [P, m] int32
    part_cbit: torch.Tensor,  # [P, m] int32 bit pattern
    part_date: torch.Tensor,  # [P, m] int32
    qwords: torch.Tensor,  # [B, W] int32 (pack_court_words)
    date_lo: torch.Tensor,  # [B] int32
    date_hi: torch.Tensor,  # [B] int32
    min_sim: torch.Tensor,  # [B] f32
    lanes: int = LANES,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Port of ``pallas_probe_candidates`` → ``(values, slots)`` each
    ``[B, NP*2*lanes]``; slots index the partition's ``m`` axis."""
    B = q8.shape[0]
    m = part_scale.shape[1]
    if m % lanes:
        raise ValueError(f"partition size {m} not divisible by lanes {lanes}")
    i32 = torch.int32
    args = (
        q8.contiguous(), q_scale.to(torch.float32).reshape(B).contiguous(),
        top_p.to(i32).contiguous(), part_int8.contiguous(),
        part_scale.to(torch.float32).contiguous(), part_rows.to(i32).contiguous(),
        part_cword.to(i32).contiguous(), part_cbit.to(i32).contiguous(),
        part_date.to(i32).contiguous(), qwords.to(i32).contiguous(),
        date_lo.to(i32).reshape(B).contiguous(), date_hi.to(i32).reshape(B).contiguous(),
        min_sim.to(torch.float32).reshape(B).contiguous(),
    )
    if q8.is_cuda:
        if lanes != LANES:
            raise ValueError("the CUDA probe kernel runs 128 lanes")
        return probe_candidates_cuda(*args)
    return probe_candidates_plain(*args, lanes=lanes)


# ---------------------------------------------------------------------------
# 3. Gather rescore (pallas_gather_rescore)
# ---------------------------------------------------------------------------


def gather_rescore_plain(queries, corpus, candidate_idx) -> torch.Tensor:
    """Plain version of the rescore kernel: the exact gather-rescore of
    :mod:`.scoring` (f32 products and sums, TF32 off)."""
    from .scoring import gather_rescore

    exact_float32()
    return gather_rescore(queries, corpus, candidate_idx)


def gather_rescore_cuda(queries, segments, candidate_idx) -> torch.Tensor:
    """Launch ``csrc/gather_rescore.cu``: ``queries [B, D]`` f32,
    ``segments`` a tuple of ``[n_s, D]`` bf16 tensors, ``candidate_idx
    [B, C]`` int32 (clamped into the corpus) → ``[B, C]`` f32."""
    dev = queries.device
    B, D = queries.shape
    C = candidate_idx.shape[1]
    _check(queries, "queries", torch.float32, (B, D), dev)
    _check(candidate_idx, "candidate_idx", torch.int32, (B, C), dev)
    for s, seg in enumerate(segments):
        _check(seg, f"segment {s}", torch.bfloat16, (seg.shape[0], D), dev)
    if D % 2 or not 1 <= len(segments) <= 16:
        raise ValueError("rescore kernel needs even D and 1..16 segments")
    lib = load_library()
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_longlong * len(segments))(*[s.data_ptr() for s in segments])
    rows = (ctypes.c_longlong * len(segments))(*[s.shape[0] for s in segments])
    err = lib.lib.tss_gather_rescore(
        _ptr(queries), ctypes.cast(ptrs, ctypes.c_void_p),
        ctypes.cast(rows, ctypes.c_void_p), len(segments), _ptr(candidate_idx),
        _ptr(out), B, C, D, _stream(dev),
    )
    _raise_on(err, "gather rescore kernel")
    _count_launch("gather_rescore")
    return out


def gather_rescore_rows(
    queries: torch.Tensor,  # [B, D] f32 (L2-normalised)
    corpus,  # [N, D] bf16 tensor or tuple of row segments
    candidate_idx: torch.Tensor,  # [B, C] int candidate rows (>= 0)
) -> torch.Tensor:
    """Port of ``pallas_gather_rescore`` → ``[B, C]`` f32 full-precision
    scores of the candidate rows."""
    from .scoring import as_segments

    segs = as_segments(corpus)
    if queries.is_cuda:
        return gather_rescore_cuda(
            queries.to(torch.float32).contiguous(),
            tuple(s.contiguous() for s in segs),
            candidate_idx.to(torch.int32).contiguous(),
        )
    return gather_rescore_plain(queries, segs, candidate_idx)
