"""Hand-written CUDA kernels for the DSC hot spots, and how they are built.

Each kernel package mirrors ``repro.kernels``:
  ops.py — the public wrapper: a CUDA tensor launches the kernel, a CPU
           tensor takes the plain PyTorch version (never a fallback: a
           failed build or launch raises)
  ref.py — the plain PyTorch version, the oracle the tests hold the
           JAX package against

The kernels live in ``csrc/``: ``dsc_kernels.cu`` (the DSC pipeline,
K1-K13, the chunk time bounds their sweep reads and the row moments of
alpha, K16),
``lcss_kernels.cu`` (K14) and ``attention_kernels.cu`` (K15),
each a translation unit with a plain C interface.  At first use each is
compiled by its own ``nvcc`` for ``sm_90a`` (all started together) and the
objects are linked into one library under
``build/repro_torch_kernels/<hash>/`` at the root of the checkout, loaded
with ``ctypes``.  FMA contraction is off (``-fmad=false``) and
``--use_fast_math`` is never passed, so square roots and divisions stay
IEEE-rounded and the DSC and LCSS kernels agree bit for bit with their
plain versions.

``LAUNCHES`` counts the launches of each kernel; a wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("dsc_kernels.cu", "lcss_kernels.cu", "attention_kernels.cu")
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
              "--ptxas-options=-v")

LAUNCHES = {"stjoin_best_match": 0, "stjoin_vote_fused": 0,
            "jaccard_window": 0, "stjoin_sim_fused": 0,
            "stjoin_sim_panel_fused": 0, "round_scan": 0, "claim_max": 0,
            "topk_round_scan": 0, "topk_claim_max": 0,
            "stjoin_best_match_pruned": 0, "stjoin_vote_fused_pruned": 0,
            "stjoin_sim_fused_pruned": 0,
            "stjoin_sim_panel_fused_pruned": 0, "lcss_wavefront": 0,
            "flash_attention_fwd": 0, "chunk_time_bounds": 0,
            "sim_row_moments": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # ref x, y, t, id, ok; cand x, y, t, id, ok; P, C, Mc; eps_sp, eps_t;
    # chunk time bounds lo, hi; skip counts (NULL: none); best_w, best_idx;
    # stream
    "stjoin_best_match": [_P] * 10 + [ctypes.c_longlong, _I, _I,
                                      ctypes.c_float, ctypes.c_float]
                         + [_P] * 3 + [_P, _P, _P],
    # ref x, y, t, id, ok; cand x, y, t, id, ok; T, M, C, Mc; eps_sp,
    # eps_t, delta_t; chunk time bounds lo, hi; skip counts (NULL: none);
    # vote, words (NULL for TSA1), W; stream
    "stjoin_vote_fused": [_P] * 10 + [_I] * 4 + [ctypes.c_float] * 3
                         + [_P] * 3 + [_P, _P, _I, _P],
    # the K2 operands, ref_gid, cand_gid; T, M, C, Mc, ms; eps_sp, eps_t,
    # delta_t; chunk bounds lo, hi; skip counts; raw; stream
    "stjoin_sim_fused": [_P] * 12 + [_I] * 5 + [ctypes.c_float] * 3
                        + [_P] * 3 + [_P, _P],
    # the K4 operands up to ms; p0, panel; eps_sp, eps_t, delta_t; chunk
    # time bounds lo, hi; skip counts (NULL: none); fwd, rev; stream
    "stjoin_sim_panel_fused": [_P] * 12 + [_I] * 7 + [ctypes.c_float] * 3
                              + [_P] * 3 + [_P, _P, _P],
    # the K1 operands, P, C, Mc, eps_sp, eps_t; tile_ids, K; chunk bounds
    # lo, hi; skip counts; best_w, best_idx; stream
    "stjoin_best_match_pruned": [_P] * 10 + [ctypes.c_longlong, _I, _I,
                                             ctypes.c_float, ctypes.c_float,
                                             _P, _I] + [_P] * 3
                                + [_P, _P, _P],
    # t, ok; R, N, chunk; lo, hi; stream
    "chunk_time_bounds": [_P, _P, ctypes.c_longlong, _I, _I, _P, _P, _P],
    # sim, its row stride; row_valid, col_valid; R, N; count, sum, sumsq;
    # stream
    "sim_row_moments": [_P, ctypes.c_longlong, _P, _P, _I, _I, _P, _P, _P,
                        _P],
    # the K2 operands up to W; tile_ids, K; stream
    "stjoin_vote_fused_pruned": [_P] * 10 + [_I] * 4
                                + [ctypes.c_float] * 3 + [_P] * 3
                                + [_P, _P, _I, _P, _I, _P],
    # the K4 operands up to delta_t; live (row, tile) pairs, their count;
    # chunk bounds lo, hi; skip counts; raw; stream
    "stjoin_sim_fused_pruned": [_P] * 12 + [_I] * 5 + [ctypes.c_float] * 3
                               + [_P, ctypes.c_longlong] + [_P] * 3
                               + [_P, _P],
    # the K7 operands up to delta_t; forward pairs and count, reverse
    # pairs and count; c_lo, c_hi; chunk bounds, skip counts; fwd, rev;
    # stream
    "stjoin_sim_panel_fused_pruned": [_P] * 12 + [_I] * 7
                                     + [ctypes.c_float] * 3
                                     + [_P, ctypes.c_longlong] * 2
                                     + [_I, _I] + [_P] * 3 + [_P, _P, _P],
    # masks, valid, T, M, W, w, slab J, scratch (NULL: shared memory),
    # scratch blocks, d, stream
    "jaccard_window": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P],
    # sim, rank, unresolved, is_rep, alpha on the card (NULL: the next),
    # alpha, S, blocked, claimed, stream
    "round_scan": [_P] * 5 + [ctypes.c_float, _I, _P, _P, _P],
    # sim, rank, is_rep, valid, alpha on the card (NULL: the next), alpha,
    # S, scratch, its int32 words, best_w, best_slot, stream
    "claim_max": [_P] * 5 + [ctypes.c_float, _I, _P, _I, _P, _P, _P],
    # S -> int32 words of claim_max's scratch (negative: a CUDA error)
    "claim_max_scratch": [_I],
    # S, R -> the slices of K6's list of R rows (negative: a CUDA error)
    "claim_max_slices": [_I, _I],
    # ids, sims, rank, unresolved, is_rep, alpha on the card (NULL: the
    # next), alpha, S, K, blocked, claimed, stream
    "topk_round_scan": [_P] * 6 + [ctypes.c_float, _I, _I, _P, _P, _P],
    # ids, sims, rank, is_rep, valid, alpha on the card (NULL: the next),
    # alpha, S, K, best_w, best_slot, stream
    "topk_claim_max": [_P] * 6 + [ctypes.c_float, _I, _I, _P, _P, _P],
    # rx, ry, rt, rv, sx, sy, st, sv; B, N, M; eps_sp, eps_t; carried-row
    # scratch (NULL: shared memory); scores; stream
    "lcss_wavefront": [_P] * 8 + [_I] * 3 + [ctypes.c_float] * 2
                      + [_P, _P, _P],
    # q, k, v, q_pos, kv_pos; B, Lq, M, KV, G, hd; window, prefix, max_kv;
    # softcap (0 = none); bf16 (0 = float32); path, nsplit,
    # tiles_per_split; split scratch m, l, acc; tile counters; out; stream
    "flash_attention_fwd": [_P] * 5 + [_I] * 6 + [_I] * 3
                           + [ctypes.c_float, _I] + [_I] * 3 + [_P] * 4
                           + [_P, _P],
}

_lib = None
_lib_lock = threading.Lock()
build_log = ""
# seconds of each source's compile and of the link, from the last build:
# one nvcc over all sources in turn takes about their sum
build_seconds: dict[str, float] = {}


def has_cuda() -> bool:
    """Whether a CUDA card is visible (the counterpart of the JAX
    package's ``default_interpret``: the kernels run only on the card)."""
    return torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Asking for CUDA without a card raises:
    entry points never drop to the CPU on their own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not has_cuda():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def smem_optin(index: int) -> int:
    """Bytes of shared memory one block may opt into on card ``index``."""
    props = torch.cuda.get_device_properties(index)
    return getattr(props, "shared_memory_per_block_optin", 232448)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    """Where this exact source and flag set builds: a hash of both."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _run(cmd: list[str]) -> tuple[subprocess.CompletedProcess, float]:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc, time.perf_counter() - t0


def build() -> Path:
    """Compile the kernels (once per source hash) and return the library:
    one ``nvcc -c`` per source, all started together, then one link.

    The library is written to a temporary name and renamed into place, so
    concurrent builders never load a half-written library.
    """
    global build_log, build_seconds
    out_dir = build_dir()
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objs = [out_dir / f"{Path(s).stem}.{pid}.o" for s in _SOURCES]
    steps = {s: [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(_CSRC / s)]
             for s, o in zip(_SOURCES, objs)}
    with ThreadPoolExecutor(len(steps)) as pool:
        runs = dict(zip(steps, pool.map(_run, steps.values())))
    tmp = out_dir / f"librepro_torch_kernels.{pid}.so"
    if all(proc.returncode == 0 for proc, _ in runs.values()):
        steps["link"] = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        runs["link"] = _run(steps["link"])
    for o in objs:
        o.unlink(missing_ok=True)
    build_seconds = {step: sec for step, (_, sec) in runs.items()}
    build_log = "\n".join(f"{' '.join(steps[step])}  ({sec:.1f} s)\n"
                          f"{proc.stdout}{proc.stderr}"
                          for step, (proc, sec) in runs.items())
    (out_dir / "build.log").write_text(build_log)
    failed = [step for step, (proc, _) in runs.items() if proc.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           f"{build_log}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, *args, device: torch.device) -> None:
    """Call one C launcher on ``device``'s current stream; raise on any
    launch error (``cudaGetLastError`` is the launcher's return value)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: error {err}")
    LAUNCHES[name] += 1


def check_tile_knobs(name: str, **knobs) -> None:
    """Refuse a TPU tile knob of the reference's wrappers (``bu``, ``bs``,
    ``bp``, ``bc``, ``bm``, ``rows``) that the reference's Pallas grid
    could not run: anything but ``None`` or a positive int.  The CUDA
    kernels read none of them (README, "The reference's TPU knobs")."""
    for arg, v in knobs.items():
        if v is not None and (not isinstance(v, int) or v < 1):
            raise ValueError(f"{name}: {arg} must be a positive int, got "
                             f"{v!r}")


def check_cuda_operands(name: str, **tensors) -> torch.device:
    """Every operand on one CUDA device, contiguous, of the right dtype."""
    devices = {t.device for t, _ in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {devices}")
    for arg, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    (dev,) = devices
    return dev
