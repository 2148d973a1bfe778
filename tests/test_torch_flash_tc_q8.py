"""The tensor-core flash kernel's algorithm for K12 (the int8 contiguous
chunk), held on the CPU: the tile mirror ``flash_tc_mirror`` with P in
float32 against the port's plain ``_chunk_contiguous_q8`` (atol 1e-5)
and against the JAX Pallas kernel ``flash_chunk_attention_q8`` in
interpret mode (atol 2e-5), head dim 64 and 128, GQA groups 1, 4 and 8,
every chunk shape of ``CHUNKS``; and rows past a chunk's true length.

The cases and the JAX runs are ``tests/test_torch_flash_tc.py``'s (which
holds K2, K3 and the kernel's walk, rounding and wrappers); the int8
chunk's cases are the file's slowest, so they run in a file of their own.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributed_llm_tpu_torch.ops import attention as TA
from distributed_llm_tpu_torch.ops import flash_attention as TF
from test_torch_flash_tc import CHUNKS, _chunk_case, _jax_chunk, _window
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", sorted(CHUNKS))
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_chunk_q8_mirror_matches_plain_and_jax(d, group, name):
    q, k, v, ks, vs, pos = _window(_chunk_case(d, group, name))
    assert not k.is_contiguous()
    out = TF.flash_tc_mirror(q, k, v, pos, ks, vs,
                             p_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(
        out.numpy(), TA._chunk_contiguous_q8(q, k, v, ks, vs, pos).numpy(),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), _jax_chunk(d, group, name),
                               atol=2e-5, rtol=0)


def test_chunk_q8_mirror_matches_plain_on_padded_rows():
    """Rows past a chunk's true length carry positions clamped to it (the
    kernel reads each row's position): they match the plain version too."""
    q, k, v, ks, vs, pos = _window(_chunk_case(64, 4, "rows37"))
    pos = torch.minimum(pos, pos[:, :1] + 30)
    out = TF.flash_tc_mirror(q, k, v, pos, ks, vs,
                             p_dtype=torch.float32)
    np.testing.assert_allclose(
        out.numpy(), TA._chunk_contiguous_q8(q, k, v, ks, vs, pos).numpy(),
        atol=1e-5, rtol=0)
