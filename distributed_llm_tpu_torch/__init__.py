"""PyTorch/CUDA port of distributed_llm_tpu, slice by slice.

The JAX package (``distributed_llm_tpu``) stays the reference.  This
package imports torch, numpy and the stdlib only, never JAX and nothing
of the JAX package.  Its entry points run on the card unless the caller
asks for ``device="cpu"``, which takes the plain PyTorch versions of the
hand-written CUDA kernels (``csrc/``).
"""
