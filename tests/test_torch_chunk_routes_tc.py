"""The tensor-core route of the bf16 contiguous chunk kernel (K11).

A chunk wider than the split kernel's 48 block rows runs
``csrc/flash_tc.cuh``'s tensor-core flash kernel with the window tile
source, in bf16; ``ops/flash_attention.py`` repeats it in plain PyTorch
(``flash_tc_mirror``).  Here, on the CPU, with inputs from a numpy seed:

- the mirror over a bf16 window at 16-256 rows (and 384, the Pallas wide
  regime, at a group of 1), head dim 64 and 128, groups 1, 4 and 8,
  against the port's plain ``_chunk_contiguous`` in float32 (atol 1e-5)
  and the JAX Pallas kernel ``flash_chunk_attention`` in interpret mode
  (atol 2e-5), and at 600 rows and on padded rows against the plain
  version;
- the mirror as the card rounds (P in bf16) within chip_smoke's 1e-2 row
  bound, at a few rows and at a wide chunk.

The split route, the route choice, the plans and the launches are
``tests/test_torch_chunk_routes.py``, whose helpers this file shares;
the tensor-core cases are the slowest, so they run in a file of their
own.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributed_llm_tpu_torch.ops import attention as TA
from distributed_llm_tpu_torch.ops import flash_attention as TF
from test_torch_chunk_routes import (NKV, ROW_TOL, _bf16, _jax_chunk,
                                     _row_rel_err, _split_case, _window)
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


# -- the tensor-core route: wide chunks over a bf16 window ---------------------

# name -> (rows, W, cache length, each sequence's first position).
TC_CHUNKS = {
    "rows16": (16, 100, 160, (48, 0, 84)),
    "rows37": (37, 100, 160, (27, 0, 63)),
    "rows128": (128, 256, 320, (0, 100)),
    "rows256": (256, 384, 448, (0, 128)),
    "rows384": (384, 512, 576, (0, 128)),
}


def _tc_case(d: int, group: int, name: str):
    s_c, w, s_max, starts = TC_CHUNKS[name]
    rng = np.random.default_rng(10 * d + group + 3 * s_c)
    b = len(starts)
    q = _bf16(rng.standard_normal((b, s_c, NKV * group, d)))
    k = _bf16(rng.standard_normal((b, s_max, NKV, d)))
    v = _bf16(rng.standard_normal((b, s_max, NKV, d)))
    pos = (np.asarray(starts)[:, None] + np.arange(s_c)[None]).astype(np.int32)
    return q, k, v, pos, w


# The Pallas wide regime (384 rows) at a group of 1: 64 positions a block,
# so the mirror's block loop stays short.
TC_SHAPES = [(group, name) for group in (1, 4, 8) for name in sorted(TC_CHUNKS)
             if name != "rows384" or group == 1]


@pytest.mark.parametrize("group,name", TC_SHAPES)
@pytest.mark.parametrize("d", [64, 128])
def test_tc_route_mirror_matches_plain_and_jax(d, group, name):
    case = _tc_case(d, group, name)
    q, k, v, pos = _window(*case)
    s_c = q.shape[1]
    if group * s_c > TF.SPLIT_MAX_ROWS:
        assert TF.chunk_route(s_c, NKV * group, NKV) == "tc"
    kb, vb = k.bfloat16(), v.bfloat16()             # the card's bf16 window
    out = TF.flash_tc_mirror(q, kb, vb, pos, p_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(
        out.numpy(), TA._chunk_contiguous(q, k, v, pos).numpy(), atol=1e-5,
        rtol=0)
    np.testing.assert_allclose(
        out.numpy(), _jax_chunk(("tc", d, group, name), *case), atol=2e-5,
        rtol=0)


def test_tc_route_mirror_matches_plain_at_600_rows_and_padded_rows():
    """600 rows at 300-399 over W = 1000 of 1100 (a grid past the card's
    SM count at orin's group), the last rows clamped to a true length."""
    rng = np.random.default_rng(600)
    b, s_c, w, d, group = 2, 600, 1000, 64, 4
    q = torch.from_numpy(_bf16(rng.standard_normal((b, s_c, NKV * group, d))))
    k = torch.from_numpy(_bf16(rng.standard_normal((b, 1100, NKV, d))))[:, :w]
    v = torch.from_numpy(_bf16(rng.standard_normal((b, 1100, NKV, d))))[:, :w]
    pos = (torch.tensor([300, 399])[:, None] + torch.arange(s_c)[None])
    pos = torch.minimum(pos, torch.tensor([[850], [w + 20]])).to(torch.int32)
    out = TF.flash_tc_mirror(q, k.bfloat16(), v.bfloat16(), pos,
                             p_dtype=torch.float32)
    np.testing.assert_allclose(
        out.numpy(), TA._chunk_contiguous(q, k, v, pos).numpy(), atol=1e-5,
        rtol=0)


@pytest.mark.parametrize("shape", ["rows5", "rows256"])
def test_tc_route_rounding_p_stays_within_the_row_bound(shape):
    """P rounded to bf16 before PV, as the card and the Pallas chunk
    kernels round it: every output row within chip_smoke's 1e-2 of the
    plain version in float32, and not equal to it (the rounding is
    there); at the verify's few rows and at a wide chunk."""
    if shape == "rows5":
        q, k, v, pos = _window(*_split_case(4, 5, "edge", 1))
    else:
        q, k, v, pos = _window(*_tc_case(64, 4, "rows256"))
    plain = TA._chunk_contiguous(q, k, v, pos)
    out = TF.flash_tc_mirror(q, k.bfloat16(), v.bfloat16(), pos)
    err = _row_rel_err(out, plain)
    assert 1e-4 < err <= ROW_TOL
