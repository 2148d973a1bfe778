"""Paged KV cache: block-table memory for the batched decode cache.

Counterpart of ``distributed_llm_tpu/engine/paged_kv.py``, same layout:

- one pool per tier, ``{"k", "v": [L, N_kv, num_blocks, block_size, D]}``,
  head-major so each (head, block) is a contiguous ``[block_size, D]``
  tile, the tile the attention kernels stage;
- a host-side refcounted ``BlockAllocator``; block 0 is the trash block
  that idle batch slots write into;
- each slot's block-table row maps logical position ``p`` to
  ``(table[p // bs], p % bs)``.

Where the JAX package rebuilt the pool functionally on every write, the
port writes it IN PLACE (``index_put_`` / slice assignment): the write
functions mutate ``pool`` and return it.  Duplicate indices in one write
(idle slots all writing the trash cell) are the only place the order of
writes is unspecified, and nothing reads the trash block.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional

import torch

from ..config import ModelConfig
from ..models import transformer
from ..models.transformer import Transformer
from ..ops import attention, quant

KVPool = Dict[str, torch.Tensor]    # {"k","v": [L, N_kv, NB, bs, D]}

TRASH_BLOCK = 0


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    block_size: int = 64
    max_slots: int = 4
    max_seq_len: int = 2048

    @property
    def blocks_per_slot(self) -> int:
        return -(-self.max_seq_len // self.block_size)

    @property
    def num_blocks(self) -> int:
        # Full residency for every slot, plus the reserved trash block.
        return self.max_slots * self.blocks_per_slot + 1


def init_pool(cfg: ModelConfig, pcfg: PagedConfig, device=None) -> KVPool:
    shape = (cfg.num_layers, cfg.num_kv_heads, pcfg.num_blocks,
             pcfg.block_size, cfg.head_dim)
    dtype = transformer.torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class BlockAllocator:
    """Thread-safe refcounted free list over pool blocks (block 0 is never
    handed out).  A block leaves the free list with refcount 1;
    ``share()`` increfs it for another holder (a slot mapping a parked
    prefix read-only, a parked prefix entry); ``free()`` decrefs, and a
    block reaching 0 returns to the free list.  ``free()`` validates the
    whole batch before any decref, so a bad batch changes nothing."""

    def __init__(self, num_blocks: int):
        self._free: List[int] = list(range(1, num_blocks))
        self._refs: Dict[int, int] = {}
        self._lock = threading.Lock()

    def alloc(self, n: int) -> Optional[List[int]]:
        with self._lock:
            if len(self._free) < n:
                return None
            got, self._free = self._free[:n], self._free[n:]
            for b in got:
                self._refs[b] = 1
            return got

    def share(self, blocks: List[int]) -> None:
        """Incref live blocks; sharing an unallocated block raises."""
        with self._lock:
            bad = [b for b in blocks if self._refs.get(b, 0) < 1]
            if bad:
                raise ValueError(
                    f"share() of unallocated block(s) {bad}: only live "
                    f"blocks can gain references")
            for b in blocks:
                self._refs[b] += 1

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per block (the trash block is ignored);
        freeing an unallocated block raises (double free)."""
        with self._lock:
            drops: Dict[int, int] = {}
            for b in blocks:
                if b != TRASH_BLOCK:
                    drops[b] = drops.get(b, 0) + 1
            bad = [b for b, n in drops.items() if self._refs.get(b, 0) < n]
            if bad:
                raise ValueError(
                    f"free() of unallocated block(s) {sorted(bad)} "
                    f"(double free)")
            released: List[int] = []
            for b, n in drops.items():
                r = self._refs[b] - n
                if r == 0:
                    del self._refs[b]
                    released.append(b)
                else:
                    self._refs[b] = r
            self._free.extend(released)

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._refs.get(block, 0)

    def refcounts(self, blocks: List[int]) -> List[int]:
        """Batch refcount read under one lock acquisition."""
        with self._lock:
            return [self._refs.get(b, 0) for b in blocks]

    def ref_stats(self) -> Dict[str, int]:
        with self._lock:
            return {"allocated_blocks": len(self._refs),
                    "total_refs": sum(self._refs.values()),
                    "shared_blocks": sum(1 for r in self._refs.values()
                                         if r >= 2)}

    @property
    def available(self) -> int:
        with self._lock:
            return len(self._free)


def write_prefill_blocks(pool: KVPool, blocks: torch.Tensor,
                         k_all: torch.Tensor, v_all: torch.Tensor) -> KVPool:
    """Scatter a prefilled prompt's K/V ([L, S, N_kv, D], S == nb * bs)
    into its blocks ([nb] ids), in place."""
    l, s, nkv, d = k_all.shape
    nb = blocks.shape[0]
    bs = s // nb
    ix = blocks.long()
    # [L, S, N_kv, D] -> [L, N_kv, nb, bs, D] (head-major pool tiles).
    pool["k"][:, :, ix] = k_all.reshape(l, nb, bs, nkv, d).permute(0, 3, 1, 2, 4)
    pool["v"][:, :, ix] = v_all.reshape(l, nb, bs, nkv, d).permute(0, 3, 1, 2, 4)
    return pool


def copy_block(pool: KVPool, src: int, dst: int) -> KVPool:
    """Copy block ``src``'s K/V to ``dst`` in place: the copy-on-write
    step of a shared-prefix hit whose matched length ends mid-block."""
    pool["k"][:, :, dst] = pool["k"][:, :, src]
    pool["v"][:, :, dst] = pool["v"][:, :, src]
    return pool


DecodeAttn = Callable[..., torch.Tensor]


@torch.no_grad()
def chunk_prefill_paged(cfg: ModelConfig, model: Transformer,
                        tokens: torch.Tensor,     # [1, S_c] right-padded chunk
                        start: torch.Tensor,      # [1] int32 chunk head position
                        true_len: torch.Tensor,   # [1] int32 prefix + suffix
                        pool: KVPool,
                        table: torch.Tensor,      # [MB] int32 slot's block row
                        window: int) -> torch.Tensor:
    """Prefill a prompt chunk straight into the slot's pool blocks (in
    place) and return the final-normed hidden [1, S_c, H].  Each row's
    K/V scatters to (table[p // bs], p % bs) before attention (the chunk
    attends its own K/V), and attention reads the first ``window // bs``
    table blocks, so the cost is O(window), not O(max_seq)."""
    b, s_c = tokens.shape
    d = cfg.head_dim
    bs = pool["k"].shape[3]
    x = quant.embed_rows(model.embed, tokens)                     # [1, S_c, H]
    positions = start[:, None] + torch.arange(s_c, device=tokens.device)[None]
    q_pos = torch.minimum(positions, torch.clamp(true_len, min=1)[:, None] - 1)
    sin, cos = transformer.rope_sincos(positions, d, cfg.rope_theta)
    flat_pos = positions[0].long()
    blk = table.long()[flat_pos // bs]
    off = flat_pos % bs
    for i, lp in enumerate(model.layers):
        k_pool, v_pool = pool["k"][i], pool["v"][i]
        h_in = transformer.rms_norm(x, lp.ln1, cfg.norm_eps)
        q = quant.matmul(h_in, lp.wq).reshape(b, s_c, cfg.num_heads, d)
        k = quant.matmul(h_in, lp.wk).reshape(b, s_c, cfg.num_kv_heads, d)
        v = quant.matmul(h_in, lp.wv).reshape(b, s_c, cfg.num_kv_heads, d)
        q = transformer.apply_rope(q, sin, cos)
        k = transformer.apply_rope(k, sin, cos)
        k_pool[:, blk, off] = k[0].transpose(0, 1)               # [nkv, S_c, d]
        v_pool[:, blk, off] = v[0].transpose(0, 1)
        attn = attention.paged_chunk(q, k_pool, v_pool, table, start, q_pos,
                                     window)
        x = x + quant.matmul(attn.reshape(b, s_c, cfg.num_heads * d), lp.wo)
        x = x + transformer._swiglu(
            transformer.rms_norm(x, lp.ln2, cfg.norm_eps),
            lp.w_gate, lp.w_up, lp.w_down)
    return transformer.rms_norm(x, model.final_ln, cfg.norm_eps)


@torch.no_grad()
def decode_step_paged(cfg: ModelConfig, model: Transformer,
                      token: torch.Tensor,         # [B] current input token
                      pos: torch.Tensor,           # [B] int32 its position
                      pool: KVPool,
                      tables: torch.Tensor,        # [B, MB] int32 FULL rows
                      attn: Optional[DecodeAttn] = None) -> torch.Tensor:
    """One batched decode step over the paged pool (the ragged contract:
    every slot's FULL table row and TRUE position go to one attention
    call).  Writes this step's K/V in place and returns logits [B, V]
    float32.  Idle slots point their whole row at the trash block; their
    writes land there and their logits are ignored.  ``attn`` replaces
    the attention op ``(q, k_pool, v_pool, tables, pos) -> [B, Nq, D]``."""
    b = token.shape[0]
    d = cfg.head_dim
    bs = pool["k"].shape[3]
    attn = attn or attention.ragged_decode
    x = quant.embed_rows(model.embed, token)                      # [B, H]
    sin, cos = transformer.rope_sincos(pos, d, cfg.rope_theta)
    pos_l = pos.long()
    blk = tables.long().gather(1, (pos_l // bs)[:, None])[:, 0]
    off = pos_l % bs
    for i, lp in enumerate(model.layers):
        k_pool, v_pool = pool["k"][i], pool["v"][i]
        h_in = transformer.rms_norm(x, lp.ln1, cfg.norm_eps)
        q = quant.matmul(h_in, lp.wq).reshape(b, cfg.num_heads, d)
        k = quant.matmul(h_in, lp.wk).reshape(b, cfg.num_kv_heads, d)
        v = quant.matmul(h_in, lp.wv).reshape(b, cfg.num_kv_heads, d)
        q = transformer.apply_rope(q, sin, cos)
        k = transformer.apply_rope(k, sin, cos)
        k_pool[:, blk, off] = k.transpose(0, 1)                  # [nkv, B, d]
        v_pool[:, blk, off] = v.transpose(0, 1)
        out = attn(q, k_pool, v_pool, tables, pos)
        x = x + quant.matmul(out.reshape(b, cfg.num_heads * d), lp.wo)
        x = x + transformer._swiglu(
            transformer.rms_norm(x, lp.ln2, cfg.norm_eps),
            lp.w_gate, lp.w_up, lp.w_down)
    hidden = transformer.rms_norm(x, model.final_ln, cfg.norm_eps)
    return transformer.logits_from_hidden(model, hidden)
