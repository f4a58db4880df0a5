"""The ctypes signatures of the port's kernel wrappers match the C entry
points of the CUDA sources they call.

Each `extern "C" int gamer_*(...)` in `gamer_tpu_torch/ops/csrc/*.cu` is
parsed, and the wrapper's `argtypes` list must have as many entries, of the
matching kinds: a pointer is `c_void_p`, `int` is `c_int`, `unsigned int` is
`c_uint`, `float` is `c_float`. A mismatch would garble the arguments
silently on the card (ctypes converts whatever it is given), so it is caught
here, on the CPU, without a compiler.
"""

import ctypes
import re

import pytest

from gamer_tpu_torch.ops import fused_attention as FA
from gamer_tpu_torch.ops import fused_ce as FC
from gamer_tpu_torch.ops import fused_moe as FM
from gamer_tpu_torch.ops import fused_optimizer as FO
from gamer_tpu_torch.ops import hash_dropout as HD
from gamer_tpu_torch.ops import qk_norm_rope as QN
from gamer_tpu_torch.ops._build import CSRC, KERNEL_SOURCES

WRAPPERS = {
    "gamer_fused_attention_fwd": FA._FWD_ARGTYPES,
    "gamer_fused_attention_bwd": FA._BWD_ARGTYPES,
    "gamer_fused_ce_fwd": FC._FWD_ARGTYPES,
    "gamer_fused_ce_bwd": FC._BWD_ARGTYPES,
    "gamer_fused_moe_fwd": FM._FWD_ARGTYPES,
    "gamer_fused_moe_bwd": FM._BWD_ARGTYPES,
    "gamer_hash_dropout": HD._ARGTYPES,
    "gamer_fused_optimizer": FO._ARGTYPES,
    "gamer_qk_norm_rope": QN._ARGTYPES,
}

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(gamer_\w+)\s*\(([^)]*)\)', re.S)


def _kind(param: str):
    """The ctypes type a C parameter declaration must be passed as."""
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.replace("const ", "").split()[:-1]  # drop the parameter name
    kinds = {("int",): ctypes.c_int, ("unsigned", "int"): ctypes.c_uint,
             ("unsigned",): ctypes.c_uint, ("float",): ctypes.c_float}
    if tuple(words) not in kinds:
        raise ValueError(f"unexpected C parameter type in {decl!r}")
    return kinds[tuple(words)]


def _entry_points() -> dict:
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in _ENTRY.findall(src.read_text()):
            found[name] = [_kind(p) for p in params.split(",")]
    return found


def test_every_entry_point_has_a_wrapper():
    found = _entry_points()
    assert sorted(found) == sorted(WRAPPERS)
    assert sorted(f"gamer_{n}" for n in KERNEL_SOURCES) == sorted(WRAPPERS)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_argtypes_match_the_c_entry_point(name):
    want = _entry_points()[name]
    got = WRAPPERS[name]
    assert len(got) == len(want), f"{name}: {len(got)} argtypes for {len(want)} C parameters"
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is w, f"{name} argument {i}: wrapper passes {g.__name__}, C takes {w.__name__}"


def test_parser_reads_the_parameter_kinds():
    assert _kind("const void* q") is ctypes.c_void_p
    assert _kind("float*   lse") is ctypes.c_void_p
    assert _kind("unsigned int seed") is ctypes.c_uint
    assert _kind("int\n dtype") is ctypes.c_int
    assert _kind("float inv_keep") is ctypes.c_float
    with pytest.raises(ValueError):
        _kind("double x")

