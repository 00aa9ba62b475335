"""The ctypes signature tables of the CUDA kernels against their C ABI.

ctypes does not read a library's declarations: an argument list in
`fused_mlp_lib.signatures` / `fused_tower_lib.signatures` /
`substep_kernel.signatures` (B1, with its DR operand, and B6) that differs from
the `extern "C"` declaration in csrc/ passes arguments of the wrong width
(a pointer cut to 32 bits, an int read as a pointer) without any error on
the card.  These tests parse the declarations in the sources and hold each
table entry to them: the argument count, each argument's kind (int, long
long, pointer, host array of pointers) and the return type.  They need
neither a card nor nvcc.

test_profiler_groups_name_every_kernel holds `port_bench.trace`'s kernel
groups, by which the benchmark and the smoke script sum device time per
kernel, to the `__global__` kernels of csrc/: each lands in the group
mapped here, so a renamed kernel cannot drop out of (or into) another
kernel's time.
"""
import ctypes
import os
import re

import pytest

from massive_marl_tpu_torch.ops import fused_mlp as fm
from massive_marl_tpu_torch.ops import fused_substep as fs

CSRC = os.path.join(os.path.dirname(fm.__file__), "csrc")
LIBS = (fm.fused_mlp_lib, fm.fused_tower_lib, fs.substep_kernel)
DECL = re.compile(r'extern\s+"C"\s+([\w ]+?)\s+(\w+)\s*\(([^)]*)\)', re.S)
KINDS = {ctypes.c_int: "int", ctypes.c_longlong: "long long", ctypes.c_void_p: "pointer",
         ctypes.POINTER(ctypes.c_void_p): "pointer array"}


def _kind(c_type: str) -> str:
    """The argument kind of a C parameter or return type."""
    t = " ".join(c_type.replace("*", " * ").split())
    t = re.sub(r"\bconst\b\s*", "", t).strip()
    stars = t.count("*")
    base = t.replace("*", "").strip()
    if stars == 0:
        return {"int": "int", "long long": "long long"}[base]
    return "pointer" if stars == 1 else "pointer array"


def _declarations(source: str) -> dict:
    """{function: (argument kinds, return kind)} of a source's extern "C"
    functions."""
    with open(os.path.join(CSRC, source)) as fh:
        text = re.sub(r"//[^\n]*", "", fh.read())
    out = {}
    for ret, name, params in DECL.findall(text):
        params = [p.strip() for p in params.split(",") if p.strip()]
        # drop the parameter's name: the last identifier
        kinds = [_kind(re.sub(r"\b\w+\s*$", "", p)) for p in params]
        out[name] = (kinds, _kind(ret))
    return out


CASES = [(lib, name) for lib in LIBS for name in sorted(_declarations(lib.source))]


def test_every_declaration_has_a_table_entry():
    for lib in LIBS:
        assert sorted(_declarations(lib.source)) == sorted(lib.signatures), lib.source


def test_parser_reads_the_kinds():
    assert _kind("const void* const*") == "pointer array"
    assert _kind("void* const*") == "pointer array"
    assert _kind("const void*") == "pointer" and _kind("void *") == "pointer"
    assert _kind("long long") == "long long" and _kind("int") == "int"


@pytest.mark.parametrize("lib,name", CASES, ids=[f"{lib.source}:{name}" for lib, name in CASES])
def test_signature_matches_declaration(lib, name):
    kinds, ret = _declarations(lib.source)[name]
    argtypes, restype = lib.signatures[name]
    assert len(argtypes) == len(kinds), f"{name}: {len(argtypes)} ctypes arguments, C has {len(kinds)}"
    for i, (t, k) in enumerate(zip(argtypes, kinds)):
        assert KINDS[t] == k, f"{name} argument {i}: ctypes {KINDS[t]}, C {k}"
    assert KINDS[restype] == ret, f"{name} returns {ret}, ctypes says {KINDS[restype]}"


# the group each kernel's device time belongs to in the benchmark's
# breakdown (port_bench.trace.kernel_group); the box kernel has no group of
# its own there and is filed under "other"
KERNEL_GROUP_OF = {
    "substep_kernel": "B1 substep kernel",
    "box_body_step": "other",
    "dense_fwd_wgmma_kernel": "B2 dense_elu_ln fwd",
    "ln_bwd_rows_wgmma_kernel": "B3 dense_elu_ln bwd row pass",
    "tower_fwd_wgmma_kernel": "B4 mlp_tower fwd",
    "tower_bwd_wgmma_kernel": "B5 mlp_tower bwd row pass",
    "dw_wgmma_kernel": "B3/B5 dW pass",
    "reduce_dw_kernel": "B3/B5 dW pass",
    "colsum_partial_kernel": "B3/B5 partial-sum reductions",
    "colsum_final_kernel": "B3/B5 partial-sum reductions",
}


def _global_kernels() -> set:
    """Names of the __global__ functions defined in csrc/."""
    names = set()
    for fname in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, fname)) as fh:
            text = re.sub(r"//[^\n]*", "", fh.read())
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                text))
    return names


def test_profiler_groups_name_every_kernel():
    from port_bench.trace import kernel_group
    kernels = _global_kernels()
    assert kernels == set(KERNEL_GROUP_OF), kernels ^ set(KERNEL_GROUP_OF)
    for name in sorted(kernels):
        # the profiler names a template instance with its namespace and arguments
        shown = f"void (anonymous namespace)::{name}<4>(CUtensorMap_st, int)"
        assert kernel_group(shown) == KERNEL_GROUP_OF[name], name
    b2, b4 = "B2 dense_elu_ln fwd", "B4 mlp_tower fwd"
    assert kernel_group("tower_fwd_wgmma_kernel") != b2
    assert kernel_group("dense_fwd_wgmma_kernel") != b4
