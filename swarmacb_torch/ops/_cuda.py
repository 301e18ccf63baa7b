"""Build and load the port's CUDA kernels: nvcc → shared library → ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on first
use into its own shared library under ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``). The library's name carries a hash of
the source and the flags, so an edited source is rebuilt and a stale one is
never loaded. ``build()`` starts one nvcc for each source, all at once.

Flags: ``sm_90a`` (Hopper), ``-O3``, and no ``--use_fast_math`` — fast math
turns ``sqrtf`` and division into approximations, and the sensor kernel's
comparisons (cone test, range tests, ``u ∈ [0, 1]``) would then flip against
the plain version at their boundaries. ``pairwise.cu`` and
``fused_step.cu`` also turn off FMA contraction so that each of their
products and sums rounds as the plain PyTorch version's separate operations
do; K4's machine latches and reward counts hang on threshold tests of such
sums. ``baseline_tail.cu`` (K3b) caps its
kernels at 168 registers a thread; each of them also sets its own budget
with ``__launch_bounds__`` (the rows kernel three blocks of 128 threads an
SM, the two batched products two blocks each), and
``scripts/time_tail_backward.py`` prints what ptxas gave each of them.
``tail_forward.cu`` (K3f) takes no cap: its kernel's ``__launch_bounds__``
asks for one block of 512 threads an SM (128 registers a thread).
``cf_attention.cu`` (K5f, K5b) caps at 168 registers too; the rows
kernels of both directions ask for four blocks of 128 threads an SM (128
registers), and ``chip_smoke.py`` (phases 2d, 2e) and
``scripts/time_cf_backward.py`` print what ptxas gave each kernel. The
critic's wide route (``tail_wide.cu``, ``cf_attention_wide.cu``, which
share ``wide_common.cuh``) takes no cap: the kernels set their budgets
with ``__launch_bounds__`` (one rows block an SM: 256 threads in
``tail_wide.cu``, 512 in ``cf_attention_wide.cu``; the tensor-core product
one block of 512), and ``chip_smoke.py``
phase 2h prints their registers and spills. ``tail_forward.cu`` and the
wide route's products share ``tc_common.cuh`` (cp.async, the TF32 split,
wgmma). The env kernels' wide route (``pairwise_wide.cu``;
``fused_step_wide.cu``, which includes ``fused_step.cu`` for its device
functions) builds with FMA contraction off, as its tuned kernels do. A
library's hash covers its source, every ``csrc/*.cuh`` header and every
file the source includes by a quoted ``#include``, so an edited header or
included source rebuilds the sources that read it.

Nothing here runs when the package is imported: the CPU tests import every
module, and the CPU has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

_COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source stem → extra nvcc flags
SOURCES = {
    "pairwise": ("-fmad=false",),
    "baseline_tail": ("-maxrregcount=168",),
    "tail_forward": (),
    "cf_attention": ("-maxrregcount=168",),
    "fused_step": ("-fmad=false",),
    "tail_wide": (),
    "cf_attention_wide": (),
    "pairwise_wide": ("-fmad=false",),
    "fused_step_wide": ("-fmad=false",),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types (every pointer and the stream
# as c_void_p, so ctypes never cuts a 64-bit address to an int)
SIGNATURES = {
    "pairwise": {
        "pairwise_sensors_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P,
                                    _I, _I, _F, _F, _F, _F, _P],
        "robot_collisions_launch": [_P, _P, _I, _I, _F, _F, _P],
    },
    "baseline_tail": {
        "tail_bwd_rows_launch": [_P] * 12 + [_I, _I, _I, _I, _P],
        "tail_bwd_wa_launch": [_P] * 6 + [_I, _I, _I, _I, _P],
        "tail_bwd_attn_launch": [_P] * 3 + [_I, _I, _I, _I, _P],
    },
    "tail_forward": {
        "tail_forward_launch": [_P] * 8 + [_I, _I, _I, _I, _P],
    },
    "cf_attention": {
        "cf_bwd_base_launch": [_P] * 7 + [_I, _I, _I, _I, _F, _P],
        "cf_fwd_rows_launch": [_P] * 8 + [_I, _I, _I, _I, _P],
        "cf_bwd_rows_launch": [_P] * 15 + [_I, _I, _I, _I, _F, _P],
        "cf_bwd_sums_launch": [_P] * 6 + [_I, _I, _I, _I, _P],
        "cf_bwd_products_launch": [_P] * 8 + [_I, _I, _I, _I, _F, _P],
    },
    "fused_step": {
        "fused_step_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "tail_wide": {
        "tail_wide_forward_launch": [_P] * 9 + [_I] * 5 + [_P],
        "tail_wide_bwd_rows_launch": [_P] * 12 + [_I] * 6 + [_P],
        "tail_wide_bwd_wa_launch": [_P] * 6 + [_I, _I, _I, _I, _P],
        "tail_wide_bwd_attn_launch": [_P] * 3 + [_I, _I, _I, _I, _P],
    },
    "cf_attention_wide": {
        "cf_wide_base_launch": [_P] * 8 + [_I, _I, _I, _I, _F, _P],
        "cf_wide_fwd_rows_launch": [_P] * 10 + [_I] * 5 + [_P],
        "cf_wide_bwd_rows_launch": [_P] * 18 + [_I] * 7 + [_F, _P],
        "cf_wide_bwd_sums_launch": [_P] * 6 + [_I, _I, _I, _I, _P],
        "cf_wide_bwd_products_launch": [_P] * 8 + [_I, _I, _I, _I, _F, _P],
    },
    "pairwise_wide": {
        "pairwise_sensors_wide_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P,
                                         _I, _I, _F, _F, _F, _F, _F, _F, _P],
        "robot_collisions_wide_launch": [_P, _P, _I, _I, _F, _F, _P],
    },
    "fused_step_wide": {
        "fused_step_wide_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _F, _F, _P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}

# Launches of each kernel since the last reset: a wrapper adds one where it
# launches its kernel and nowhere else (plain-version calls do not count).
launches: dict[str, int] = {"pairwise_sensors": 0,
                            "resolve_robot_collisions": 0,
                            "fused_tail": 0,
                            "fused_tail_bwd": 0,
                            "fused_cf_attention": 0,
                            "fused_cf_attention_bwd": 0,
                            "fused_env_step": 0,
                            "fused_tail_wide": 0,
                            "fused_tail_wide_bwd": 0,
                            "fused_cf_attention_wide": 0,
                            "fused_cf_attention_wide_bwd": 0,
                            "pairwise_sensors_wide": 0,
                            "resolve_robot_collisions_wide": 0,
                            "fused_env_step_wide": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def _target(name: str, nvcc: str) -> tuple[Path, list[str]]:
    src = CSRC / f"{name}.cu"
    flags = [*_COMMON_FLAGS, *SOURCES[name]]
    included = re.findall(r'^#include "([^"]+)"', src.read_text(encoding="utf-8"), re.M)
    read = set(CSRC.glob("*.cuh")) | {CSRC / f for f in included}
    headers = b"".join(p.read_bytes() for p in sorted(read))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode())
    out = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    return out, [nvcc, *flags, "-o", str(out), str(src)]


def build(names=None) -> dict[str, float]:
    """Compile the named sources (default: all) that are not built yet.

    One nvcc process per source, all started together. Returns the wall
    seconds of the build of each source that was compiled. Raises with
    nvcc's output if any build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out, cmd = _target(name, nvcc)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd[cmd.index(str(out))] = str(tmp)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of a build."""
    out, _ = _target(name, _nvcc())
    log = out.with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        out, _ = _target(name, _nvcc())
        if not out.exists():
            build([name])
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def launch(t, what: str, entry, *args) -> None:
    """Call the C entry point ``entry(*args, stream)`` on the current
    stream of ``t``'s card, with that card made the current device, and
    raise if the launch returned a CUDA error code (cudaGetLastError). A
    ``<<<>>>`` launch goes to the current device, which refuses a stream of
    another card: a tensor on ``cuda:1`` (a seed lane of a seed mesh) needs
    the guard while the process's current device is ``cuda:0``."""
    import torch

    with torch.cuda.device(t.device):
        err = entry(*args, torch.cuda.current_stream(t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
