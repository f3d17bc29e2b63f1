"""The port's one boundary to its native code (lightzero_tpu_torch/_build.py).

On the CPU: the route of the three ops that launch a kernel (the descent,
the backup and the channel norm): CPU tensors take the plain version and
count no launch, a tensor on another device raises. With a stand-in library
(a C++ source written here, built with g++ as the replay core is): a
launcher's non-zero code raises naming the entry point and is not counted,
a zero code is counted and the current stream is passed last, and the
entry points' types are declared once, when the library is loaded. The
argument check names the argument at fault, and every declared entry point
is in its library's source. This file imports no JAX."""
import ctypes
import os
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch import nn

from lightzero_tpu_torch import _build
from lightzero_tpu_torch.models.channel_norm import channel_norm, channel_norm_reference
from lightzero_tpu_torch.models.common import LAYER_NORM_EPS
from lightzero_tpu_torch.search.fused_backup import fused_backup, fused_backup_reference
from lightzero_tpu_torch.search.fused_traverse import (
    check_inputs,
    fused_traverse,
    fused_traverse_reference,
)
from lightzero_tpu_torch.search.tree import Tree, map_embedding
from test_torch_fused_backup import assert_trees_equal, captured_backup

pytestmark = pytest.mark.unittest

# ------------------------------------------------------------------ route

ROUTE_CASES = (
    [("fused_traverse", "cpu"), ("fused_traverse", "meta"),
     ("fused_backup", "cpu"), ("fused_backup", "meta")]
    + [(f"channel_norm C={C}{' residual' if res else ''}", "cpu")
       for C in (16, 32, 64, 96) for res in (False, True)]
    + [("channel_norm C=16", "meta")]
)


def _traverse_case(device):
    B, A, N = 4, 2, 7
    d = check_inputs(np.random.default_rng(3), B, A, N, with_noise=True)
    args = [None if d[k] is None else torch.from_numpy(d[k]).to(device)
            for k in ("packed", "vmin", "vmax", "root_stats", "noise_u")]
    kw = dict(A=A, N=N, max_depth=N + 1, discount=0.997, pb_c_base=19652.0, pb_c_init=1.25,
              value_delta_max=0.01, tie_break_first=False, tie_break_epsilon=1e-6)

    def check(got):
        for g, e in zip(got, fused_traverse_reference(*args, **kw)):
            assert torch.equal(g, e)

    return lambda: fused_traverse(*args, **kw), check


def _backup_case(device):
    c = captured_backup()
    move = lambda x: x.to(device) if isinstance(x, torch.Tensor) else x  # noqa: E731
    tree = Tree(*(map_embedding(move, v) for v in c["tree"]))
    st = type(c["st"])(*(move(v) for v in c["st"]))
    out = type(c["out"])(*(map_embedding(move, v) for v in c["out"]))
    exp_tree = Tree(*(map_embedding(torch.clone, v) for v in c["tree"]))

    def check(got):
        assert_trees_equal(got, fused_backup_reference(c["cfg"], exp_tree, st, 5, out))

    return lambda: fused_backup(c["cfg"], tree, st, 5, out), check


def _norm_case(op, device):
    C = int(op.split()[1][2:])
    g = torch.Generator().manual_seed(C)
    x = (torch.randn((3, 5, 4, C), generator=g) * 2.0 + 0.5).to(device)
    res = torch.randn((3, 5, 4, C), generator=g).to(device) if "residual" in op else None
    norm = nn.LayerNorm(C, eps=LAYER_NORM_EPS)
    with torch.no_grad():
        norm.weight.copy_(1.0 + 0.1 * torch.randn(C, generator=g))
        norm.bias.copy_(0.1 * torch.randn(C, generator=g))
    norm = norm.to(device)

    def check(got):
        assert torch.equal(got, channel_norm_reference(x, norm, res))

    return lambda: channel_norm(x, norm, residual=res), check


@pytest.mark.parametrize("op,device", ROUTE_CASES)
def test_the_route(op, device, monkeypatch):
    monkeypatch.setattr(_build, "launches", defaultdict(int))
    name = op.split()[0]
    if name == "fused_traverse":
        call, check = _traverse_case(device)
    elif name == "fused_backup":
        call, check = _backup_case(device)
    else:
        call, check = _norm_case(op, device)
    if device != "cpu":
        with pytest.raises(ValueError, match=f"{name} runs on cuda or cpu tensors, not meta"):
            call()
        return
    check(call())
    assert not _build.launches  # only kernel launches count


# -------------------------------------------------------- the stand-in

STAND_IN = r"""
extern "C" int stand_in_launch(int code, void* stream) {
  // the code it is given, or 1 where the stream is not the stand-in's
  return code ? code : (stream == (void*)0x1234 ? 0 : 1);
}
"""


@pytest.fixture(scope="module")
def stand_in_source(tmp_path_factory):
    csrc = tmp_path_factory.mktemp("csrc")
    (csrc / "stand_in.cpp").write_text(STAND_IN)
    return csrc


@pytest.fixture
def stand_in(stand_in_source, monkeypatch):
    """``_build`` with a stand-in library declared and a stand-in stream;
    the library is built once for the module."""
    monkeypatch.setattr(_build, "CSRC_DIR", str(stand_in_source))
    monkeypatch.setattr(_build, "BUILD_DIR", str(stand_in_source / "build"))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "launches", defaultdict(int))
    monkeypatch.setattr(_build, "ENTRY_POINTS", dict(
        _build.ENTRY_POINTS,
        stand_in_launch=("stand_in", ctypes.c_int, [ctypes.c_int, ctypes.c_void_p])))
    monkeypatch.setattr(_build, "_stream", lambda device: 0x1234)


def test_a_non_zero_code_raises_naming_the_entry_point(stand_in):
    with pytest.raises(RuntimeError, match="stand_in_launch failed with CUDA error 700"):
        _build.launch("stand_in_launch", torch.device("cpu"), 700)


def test_a_failed_launch_is_not_counted(stand_in):
    with pytest.raises(RuntimeError):
        _build.launch("stand_in_launch", torch.device("cpu"), 2)
    assert _build.launches["stand_in_launch"] == 0
    # a zero code: counted, so the current stream reached the launcher last
    _build.launch("stand_in_launch", torch.device("cpu"), 0)
    _build.launch("stand_in_launch", torch.device("cpu"), 0)
    assert _build.launches == {"stand_in_launch": 2}


def test_bindings_are_declared_once_when_the_library_loads(stand_in):
    fn = _build.entry("stand_in_launch")
    assert fn.restype is ctypes.c_int
    assert tuple(fn.argtypes) == (ctypes.c_int, ctypes.c_void_p)
    # nothing declares them again: neither a launch nor another lookup
    fn.restype = ctypes.c_long
    _build.launch("stand_in_launch", torch.device("cpu"), 0)
    assert _build.entry("stand_in_launch") is fn and fn.restype is ctypes.c_long
    assert _build.load("stand_in") is _build._loaded["stand_in"]


# ------------------------------------------------------------ arguments

@pytest.mark.parametrize("case,message", [
    ("device", "x is on meta, expected cpu"),
    ("dtype", "x has dtype torch.float64, expected torch.float32"),
    ("shape", r"x has shape \(3, 2\), expected \(2, 3\)"),
    ("layout", "x is not contiguous"),
])
def test_check_names_the_argument_at_fault(case, message):
    x = {"device": torch.zeros((2, 3), device="meta"),
         "dtype": torch.zeros((2, 3), dtype=torch.float64),
         "shape": torch.zeros((3, 2)),
         "layout": torch.zeros((3, 2)).t()}[case]
    with pytest.raises(ValueError, match=message):
        _build.check("x", x, (2, 3), torch.device("cpu"))


def test_check_gives_the_address_or_none():
    x = torch.zeros((2, 3), dtype=torch.int32)
    assert _build.check("x", x, (2, 3), x.device, torch.int32) == x.data_ptr()
    assert _build.check("absent", None, (2, 3), x.device) is None


@pytest.mark.parametrize("name", sorted(_build.ENTRY_POINTS))
def test_every_declared_entry_point_is_in_its_source(name):
    library = _build.ENTRY_POINTS[name][0]
    path = next(p for p in (os.path.join(_build.CSRC_DIR, library + ext) for ext in (".cu", ".cpp"))
                if os.path.exists(p))
    with open(path) as f:
        assert f" {name}(" in f.read()
