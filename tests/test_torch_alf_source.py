"""The ALF kernels' CUDA source against the launcher module that reads
it (no device, no nvcc): the vector kernels that
``alf_step.vec_kernel_info`` names by op code are the ones
``alf_vec_kernel_info`` dispatches, each C entry that runs on the shared
vector kernel launches through ``launch_vec``, and only
``alf_inverse_update`` is left on the scalar grid-stride loop."""
from __future__ import annotations

import re

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.alf_step import alf_step

SOURCE = build.source_path("alf_step")

# The functor of each vector kernel, by C entry.
VEC_OPS = {"alf_midpoint": "MidpointOp", "alf_update": "UpdateOp",
           "alf_midpoint_vjp": "MidpointVjpOp", "alf_bwd_pre": "BwdPreOp",
           "alf_bwd_post": "BwdPostOp", "alf_update_vjp": "UpdateVjpOp",
           "alf_inverse": "InverseOp"}


def _text() -> str:
    return SOURCE.read_text()


def _launcher(text: str, entry: str) -> str:
    """The body of the template ``launch_<entry>`` (the entry's name
    without its ``alf_`` prefix), up to the next top-level brace."""
    name = "launch_" + entry[len("alf_"):]
    m = re.search(r"\nint " + name + r"\(.*?\n}\n", text, re.S)
    assert m is not None, f"{name} not found in {SOURCE.name}"
    return m.group(0)


def test_vec_kernel_info_op_codes_match_vec_kernels():
    """``VEC_KERNELS[i]`` is the functor ``alf_vec_kernel_info`` reads
    for op code i, name for name and in order."""
    cases = re.findall(r"case (\d+): return vec_info<(\w+), T>", _text())
    codes = [int(c) for c, _ in cases]
    assert codes == list(range(len(alf_step.VEC_KERNELS)))
    assert [op for _, op in cases] == [VEC_OPS[n]
                                       for n in alf_step.VEC_KERNELS]


@pytest.mark.parametrize("op", ["UpdateVjpOp", "InverseOp"])
def test_functor_exists(op):
    text = _text()
    assert re.search(r"template <typename T>\s*struct " + op + r" \{", text)
    body = text[text.index(f"struct {op} {{"):]
    body = body[:body.index("\n};\n")]
    assert "static constexpr int kIn =" in body
    assert "static constexpr bool kPhaseMasks =" in body
    assert "operator()(const A* x, A* y) const" in body


@pytest.mark.parametrize("entry", sorted(VEC_OPS))
def test_vector_entries_launch_through_launch_vec(entry):
    body = _launcher(_text(), entry)
    assert f"launch_vec<{VEC_OPS[entry]}, T>(" in body
    assert "LAUNCH_LOOP" not in body


def test_alf_inverse_update_is_the_only_entry_left_on_the_scalar_loop():
    text = _text()
    users = re.findall(r"\n  LAUNCH_LOOP\((\w+),", text)
    assert users == ["inverse_update_kernel"]
    assert "LAUNCH_LOOP(" in _launcher(text, "alf_inverse_update")
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\(\w+\)\s*)?"
                         r"(\w+)\(", text)
    assert sorted(kernels) == ["inverse_update_kernel", "vec_kernel"]
    # the C entries and the launcher module's symbols are the same eight
    entries = re.findall(r"\nint (alf_\w+)\(int dtype, int64_t n,", text)
    assert sorted(entries) == sorted(alf_step._ARGTYPES)
    assert set(alf_step.VEC_KERNELS) | {"alf_inverse_update"} == set(entries)
