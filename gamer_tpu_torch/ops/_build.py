"""Build the CUDA sources under `ops/csrc/` with nvcc for `sm_90a`, at first use.

Each `<name>.cu` compiles into its own shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes seconds).
Libraries go to `ops/_build/` (git-ignored), named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is reused.
`build()` starts one nvcc per missing library, all at once, and waits for
them; a failed build raises with nvcc's output. Processes that build at
once (a process group on one machine) take turns on an `flock` of
`_build/.lock`, which the system drops with its holder, and each library
appears by an atomic rename, so a loader never sees half a file.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNEL_SOURCES = ("fused_attention_fwd", "fused_attention_bwd", "fused_moe_fwd", "fused_moe_bwd",
                  "fused_ce_fwd", "fused_ce_bwd", "hash_dropout", "fused_optimizer",
                  "qk_norm_rope")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is "
                       "installed (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


@contextlib.contextmanager
def build_lock(directory: Path):
    """An exclusive `flock` on `directory/.lock` while the block runs."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every library of `names` that is not built yet, in parallel.
    Returns {name: nvcc's output} for the libraries compiled by this call
    (ptxas prints each kernel's registers and shared memory there)."""
    with build_lock(BUILD_DIR):
        return _build_unlocked(names)


def _build_unlocked(names) -> dict[str, str]:
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.gamer_error_string.argtypes = [ctypes.c_int]
            lib.gamer_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def launch(name: str, argtypes: list, *args) -> None:
    """Call the C entry point `gamer_<name>` of library `name` (building and
    loading it at first use) and raise on the nonzero cudaError_t it returns:
    a refused launch never runs, and a later synchronize would not report it."""
    lib = load(name)
    fn = getattr(lib, f"gamer_{name}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    code = fn(*args)
    if code != 0:
        msg = lib.gamer_error_string(code).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {code} ({msg})")


def dtype_code(t: torch.Tensor) -> int:
    """The kernels' dtype code (common.cuh `gamer::DType`) of a tensor."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {t.dtype}")
    return codes[t.dtype]


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of a tensor's device, as the int ctypes passes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous at a 16-byte aligned address (the bf16 kernels copy
    16-byte vectors); a view at an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def split_rows(rows: int, tiles: int, sms: int, step: int) -> tuple[int, int]:
    """(splits, rows a split) of a sum over `rows` that a kernel splits
    across CTAs beside its `tiles` output tiles: tiles times the splits fit
    two waves of two CTAs on each of `sms` SMs (no third, nearly empty wave
    trails the two), each split whole `step`-row slices and, where there
    are enough rows, about 256 rows or more."""
    want = max(1, min(4 * sms // max(tiles, 1), math.ceil(rows / 256)))
    chunk = math.ceil(math.ceil(rows / want) / step) * step
    return math.ceil(rows / chunk), chunk
