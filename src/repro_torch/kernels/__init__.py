"""Hand-written CUDA kernels for the DSC hot spots, and how they are built.

Each kernel package mirrors ``repro.kernels``:
  ops.py — the public wrapper: a CUDA tensor launches the kernel, a CPU
           tensor takes the plain PyTorch version (never a fallback: a
           failed build or launch raises)
  ref.py — the plain PyTorch version, the oracle the tests hold the
           JAX package against

The kernels live in ``csrc/dsc_kernels.cu``: one translation unit with a
plain C interface, compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/repro_torch_kernels/<hash>/`` at the root of the checkout, and
loaded with ``ctypes``.  FMA contraction is off (``-fmad=false``) and
``--use_fast_math`` is never passed, so square roots and divisions stay
IEEE-rounded and the kernels agree bit for bit with their plain versions.

``LAUNCHES`` counts the launches of each kernel; a wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("dsc_kernels.cu",)
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "--ptxas-options=-v")

LAUNCHES = {"stjoin_best_match": 0, "stjoin_vote_fused": 0,
            "jaccard_window": 0, "stjoin_sim_fused": 0,
            "stjoin_sim_panel_fused": 0, "round_scan": 0, "claim_max": 0,
            "topk_round_scan": 0, "topk_claim_max": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # ref x, y, t, id, ok; cand x, y, t, id, ok; P, C, Mc; eps_sp, eps_t;
    # best_w, best_idx; stream
    "stjoin_best_match": [_P] * 10 + [ctypes.c_longlong, _I, _I,
                                      ctypes.c_float, ctypes.c_float,
                                      _P, _P, _P],
    # ref x, y, t, id, ok; cand x, y, t, id, ok; T, M, C, Mc; eps_sp,
    # eps_t, delta_t; vote, words (NULL for TSA1), W; stream
    "stjoin_vote_fused": [_P] * 10 + [_I] * 4 + [ctypes.c_float] * 3
                         + [_P, _P, _I, _P],
    # the K2 operands, ref_gid, cand_gid; T, M, C, Mc, ms; eps_sp, eps_t,
    # delta_t; raw; stream
    "stjoin_sim_fused": [_P] * 12 + [_I] * 5 + [ctypes.c_float] * 3
                        + [_P, _P],
    # the K4 operands up to ms; p0, panel; eps_sp, eps_t, delta_t; fwd,
    # rev; stream
    "stjoin_sim_panel_fused": [_P] * 12 + [_I] * 7 + [ctypes.c_float] * 3
                              + [_P, _P, _P],
    # masks, T, M, W, w, d, stream
    "jaccard_window": [_P, _I, _I, _I, _I, _P, _P],
    # sim, rank, unresolved, is_rep, alpha, S, n_split, blocked, claimed,
    # stream
    "round_scan": [_P, _P, _P, _P, ctypes.c_float, _I, _I, _P, _P, _P],
    # sim, rank, is_rep, valid, alpha, S, scratch_w, scratch_rank,
    # scratch_slot, n_split, best_w, best_slot, stream
    "claim_max": [_P, _P, _P, _P, ctypes.c_float, _I, _P, _P, _P, _I,
                  _P, _P, _P],
    # ids, sims, rank, unresolved, is_rep, alpha, S, K, blocked, claimed,
    # stream
    "topk_round_scan": [_P] * 5 + [ctypes.c_float, _I, _I, _P, _P, _P],
    # ids, sims, rank, is_rep, valid, alpha, S, K, best_w, best_slot,
    # stream
    "topk_claim_max": [_P] * 5 + [ctypes.c_float, _I, _I, _P, _P, _P],
}

_lib = None
_lib_lock = threading.Lock()
build_log = ""


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


def build() -> Path:
    """Compile the kernels (once per source hash) and return the library.

    The output is written to a temporary name and renamed into place, so
    concurrent builders never load a half-written library.
    """
    global build_log
    out_dir = build_dir()
    lib = out_dir / "libdsc_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libdsc_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(_CSRC / s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + build_log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
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
