"""Paged KV cache: block-table memory for the batched decode cache.

Counterpart of ``distributed_llm_tpu/engine/paged_kv.py``, same layout:

- one pool per tier, ``{"k", "v": [L, N_kv, num_blocks, block_size, D]}``,
  head-major so each (head, block) is a contiguous ``[block_size, D]``
  tile, the tile the attention kernels stage; an int8 pool
  (``kv_quantize="int8"``) adds float32 per-row scales
  ``{"ks", "vs": [L, N_kv, num_blocks, block_size]}`` and every write
  quantizes (``ops/quant.put_kv_rows``);
- a host-side refcounted ``BlockAllocator``; block 0 is the trash block
  that idle batch slots write into;
- each slot's block-table row maps logical position ``p`` to
  ``(table[p // bs], p % bs)``.

Where the JAX package rebuilt the pool functionally on every write, the
port writes it IN PLACE (``index_put_`` / slice assignment): the write
functions mutate ``pool`` and return it.  Duplicate indices in one write
(idle slots all writing the trash cell) are the only place the order of
writes is unspecified, and nothing reads the trash block.

A tensor-parallel engine keeps one pool per head shard (a list,
``parallel/sharding.kv_pool_shards``) under the one allocator and the
one set of block tables: every write, copy, gather and scatter here
walks the shards (``transformer.kv_shards``), and the step functions run
each shard's heads on its own pool (``transformer.run_layers``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import torch

from ..config import ModelConfig
from ..models import transformer
from ..models.transformer import Transformer
from ..ops import attention, quant

KVPool = Dict[str, torch.Tensor]    # {"k","v": [L, N_kv, NB, bs, D]}
                                    # (+ "ks","vs": [L, N_kv, NB, bs])

TRASH_BLOCK = 0


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    block_size: int = 64
    max_slots: int = 4
    max_seq_len: int = 2048
    # Pool size override (TierConfig.kv_pool_blocks): a pool smaller than
    # full residency is the regime where KV-aware admission and
    # preemption with replay (engine/batching.py) bind.
    pool_blocks: Optional[int] = None

    @property
    def blocks_per_slot(self) -> int:
        return -(-self.max_seq_len // self.block_size)

    @property
    def num_blocks(self) -> int:
        if self.pool_blocks is not None:
            # Explicit pool budget, plus the reserved trash block.
            return self.pool_blocks + 1
        # Full residency for every slot, plus the reserved trash block.
        return self.max_slots * self.blocks_per_slot + 1


def init_pool(cfg: ModelConfig, pcfg: PagedConfig, kv_quantize: str = "none",
              device=None, kv_heads: Optional[int] = None) -> KVPool:
    """Zeroed pool; ``kv_quantize="int8"`` stores K/V as int8 with
    float32 per-row scales initialised to ones.  ``kv_heads`` (default
    N_kv): a head shard's count."""
    shape = (cfg.num_layers, kv_heads or cfg.num_kv_heads, pcfg.num_blocks,
             pcfg.block_size, cfg.head_dim)
    if kv_quantize == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.ones(shape[:-1], dtype=torch.float32, device=device),
                "vs": torch.ones(shape[:-1], dtype=torch.float32, device=device)}
    if kv_quantize != "none":
        raise ValueError(f"kv_quantize={kv_quantize!r}: expected 'none' or "
                         "'int8'")
    dtype = transformer.torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gather_blocks(pool: KVPool, blocks: torch.Tensor) -> KVPool:
    """Snapshot ``blocks``' K/V tiles (and int8 scales) out of the pool:
    ``[L, N_kv, nb, bs, D]`` (scales ``[L, N_kv, nb, bs]``), the DEMOTE
    copy of the host spill tier (engine/kv_spill.py).  The output is a
    fresh tensor that owns its data, so the source blocks may return to
    the free list once the gather is issued: later pool writes on the
    same stream run after it and never reach the snapshot.  A sharded
    pool's tiles are its shards' joined on the head axis, on the first
    shard's device: the layout of the unsharded pool."""
    if isinstance(pool, list):
        parts = [gather_blocks(p, blocks.to(p["k"].device)) for p in pool]
        lead = parts[0]["k"].device
        return {name: torch.cat([pt[name].to(lead) for pt in parts], dim=1)
                for name in parts[0]}
    return {name: t.index_select(2, blocks) for name, t in pool.items()}


def scatter_blocks(pool: KVPool, blocks: torch.Tensor,
                   tiles: KVPool) -> KVPool:
    """Write gathered tiles back into ``blocks`` in place, the PROMOTE
    copy of the host spill tier: the exact inverse of ``gather_blocks``
    (a bit-identical round trip, int8 scales included), so a promoted
    prefix serves decode exactly like one that never left the pool.  A
    sharded pool takes each shard's heads of the joined tiles."""
    if isinstance(pool, list):
        for j, p in enumerate(pool):
            n = p["k"].shape[1]
            lo = j * n
            dev = p["k"].device
            scatter_blocks(p, blocks.to(dev), {
                name: t.narrow(1, lo, n).to(dev) for name, t in tiles.items()})
        return pool
    for name, t in pool.items():
        t.index_copy_(2, blocks, tiles[name])
    return pool


def pool_block_bytes(cfg: ModelConfig, block_size: int,
                     kv_quantize: str = "none") -> int:
    """Bytes one pool block holds across layers and kv heads: K and V
    tiles, plus the float32 scales of an int8 pool (the unit
    ``TierConfig.host_kv_bytes`` budgets in)."""
    d = cfg.head_dim
    per_row = cfg.num_layers * cfg.num_kv_heads * block_size
    if kv_quantize == "int8":
        return per_row * (d * 2 + 4 * 2)
    itemsize = torch.empty((), dtype=transformer.torch_dtype(cfg)).element_size()
    return per_row * d * itemsize * 2


class BlockAllocator:
    """Thread-safe refcounted free list over pool blocks (block 0 is never
    handed out).  A block leaves the free list with refcount 1;
    ``share()`` increfs it for another holder (a slot mapping a parked
    prefix read-only, a parked prefix entry); ``free()`` decrefs, and a
    block reaching 0 returns to the free list.  ``free()`` validates the
    whole batch before any decref, so a bad batch changes nothing.
    ``peak()`` is the most blocks held at once since ``reset_peak()``."""

    def __init__(self, num_blocks: int):
        self._free: List[int] = list(range(1, num_blocks))
        self._refs: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._peak = 0

    def alloc(self, n: int) -> Optional[List[int]]:
        with self._lock:
            if len(self._free) < n:
                return None
            got, self._free = self._free[:n], self._free[n:]
            for b in got:
                self._refs[b] = 1
            self._peak = max(self._peak, len(self._refs))
            return got

    def reset_peak(self) -> None:
        with self._lock:
            self._peak = len(self._refs)

    def peak(self) -> int:
        with self._lock:
            return self._peak

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
    into its blocks ([nb] ids), in place (quantized for an int8 pool).
    A sharded pool takes its prefill's per-shard K/V lists."""
    for p, k, v in zip(transformer.kv_shards(pool),
                       transformer.kv_shards(k_all),
                       transformer.kv_shards(v_all)):
        l, s, nkv, d = k.shape
        nb = blocks.shape[0]
        bs = s // nb
        ix = (slice(None), slice(None), blocks.long().to(k.device))
        # [L, S, N_kv, D] -> [L, N_kv, nb, bs, D] (head-major pool tiles).
        quant.put_kv_rows(p, None, ix,
                          k.reshape(l, nb, bs, nkv, d).permute(0, 3, 1, 2, 4),
                          v.reshape(l, nb, bs, nkv, d).permute(0, 3, 1, 2, 4))
    return pool


def copy_block(pool: KVPool, src, dst) -> KVPool:
    """Copy block ``src``'s K/V (and int8 scales) to ``dst`` in place:
    the copy-on-write step of a shared-prefix hit whose matched length
    ends mid-block, and of a speculative round's shared frontier block.
    ``src`` and ``dst`` are block ids, or [1] index tensors on the pool's
    device (what a captured program reads: the ids it was captured with
    would be constants of the graph).  Every shard of a sharded pool."""
    for p in transformer.kv_shards(pool):
        dev = p["k"].device
        s, t = ((x.to(dev) if isinstance(x, torch.Tensor) else x)
                for x in (src, dst))
        for name in p:
            p[name][:, :, t] = p[name][:, :, s]
    return pool


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
    bs = transformer.kv_shards(pool)[0]["k"].shape[3]
    x = quant.embed_rows(model.embed, tokens)                     # [1, S_c, H]
    positions = start[:, None] + torch.arange(s_c, device=tokens.device)[None]
    q_pos = torch.minimum(positions, torch.clamp(true_len, min=1)[:, None] - 1)
    sin, cos = transformer.rope_sincos(positions, d, cfg.rope_theta)
    flat_pos = positions[0].long()
    blk = table.long()[flat_pos // bs]
    off = flat_pos % bs

    def attn(lp, h_in, i, sh):
        p, ins = sh.kv, sh.ins
        q, k, v = quant.matmul_many(h_in, (lp.wq, lp.wk, lp.wv))
        q = q.reshape(b, s_c, sh.nq, d)
        k = k.reshape(b, s_c, sh.nkv, d)
        v = v.reshape(b, s_c, sh.nkv, d)
        q = transformer.apply_rope(q, ins["sin"], ins["cos"])
        k = transformer.apply_rope(k, ins["sin"], ins["cos"])
        quant.put_kv_rows(p, i, (slice(None), ins["blk"], ins["off"]),
                          k[0].transpose(0, 1),
                          v[0].transpose(0, 1))                # [nkv, S_c, d]
        out = attention.paged_chunk(q, p["k"][i], p["v"][i], ins["table"],
                                    ins["start"], ins["q_pos"], window,
                                    *transformer.layer_scales(p, i))
        return out.reshape(b, s_c, sh.nq * d)

    x = transformer.run_layers(cfg, model, x, attn, pool, {
        "sin": sin, "cos": cos, "blk": blk, "off": off, "table": table,
        "start": start, "q_pos": q_pos})
    return transformer.rms_norm(x, model.final_ln, cfg.norm_eps)


@torch.no_grad()
def decode_step_paged(cfg: ModelConfig, model: Transformer,
                      token: torch.Tensor,         # [B] current input token
                      pos: torch.Tensor,           # [B] int32 its position
                      pool: KVPool,
                      tables: torch.Tensor,        # [B, MB] or [B, wb] int32
                      ragged: bool = True) -> torch.Tensor:
    """One batched decode step over the paged pool.  Writes this step's
    K/V in place and returns logits [B, V] float32.  Idle slots point
    their whole row at the trash block; their writes land there and their
    logits are ignored.

    Two attention contracts.  ``ragged=True`` (the default of the port's
    callers): every slot's FULL table row and TRUE position go to one
    ``attention.ragged_decode`` call.  ``ragged=False``, the dense windowed
    tick: the caller passes a TRUNCATED table [B, wb] covering every
    position this step writes (the scheduler slices to a bucketed
    high-water mark) and ``attention.paged_decode`` reads only that
    window."""
    b = token.shape[0]
    d = cfg.head_dim
    bs = transformer.kv_shards(pool)[0]["k"].shape[3]
    x = quant.embed_rows(model.embed, token)                      # [B, H]
    sin, cos = transformer.rope_sincos(pos, d, cfg.rope_theta)
    pos_l = pos.long()
    blk = tables.long().gather(1, (pos_l // bs)[:, None])[:, 0]
    off = pos_l % bs
    attn_op = attention.ragged_decode if ragged else attention.paged_decode

    def attn(lp, h_in, i, sh):
        p, ins = sh.kv, sh.ins
        q, k, v = quant.matmul_many(h_in, (lp.wq, lp.wk, lp.wv))
        q = q.reshape(b, sh.nq, d)
        k = k.reshape(b, sh.nkv, d)
        v = v.reshape(b, sh.nkv, d)
        q = transformer.apply_rope(q, ins["sin"], ins["cos"])
        k = transformer.apply_rope(k, ins["sin"], ins["cos"])
        quant.put_kv_rows(p, i, (slice(None), ins["blk"], ins["off"]),
                          k.transpose(0, 1), v.transpose(0, 1))  # [nkv, B, d]
        out = attn_op(q, p["k"][i], p["v"][i], ins["tables"], ins["pos"],
                      *transformer.layer_scales(p, i))
        return out.reshape(b, sh.nq * d)

    x = transformer.run_layers(cfg, model, x, attn, pool, {
        "sin": sin, "cos": cos, "blk": blk, "off": off, "tables": tables,
        "pos": pos})
    hidden = transformer.rms_norm(x, model.final_ln, cfg.norm_eps)
    return transformer.logits_from_hidden(model, hidden)


@torch.no_grad()
def verify_step_paged(cfg: ModelConfig, model: Transformer,
                      tokens: torch.Tensor,        # [B, G] cur + drafts
                      pos: torch.Tensor,           # [B] int32 first position
                      pool: KVPool,
                      tables: torch.Tensor         # [B, MB] int32 FULL rows
                      ) -> torch.Tensor:
    """One batched speculative-verify forward over the paged pool: the
    G = γ+1 twin of ``decode_step_paged``.  Each slot's chunk (its last
    token and its drafts) sits at positions ``pos + g``; all G rows'
    K/V are written first (write-before-attend, in place), then ONE
    ``attention.ragged_verify`` call per layer attends every slot's chunk
    against its own prefix with per-query causal masks.  Returns logits
    [B, G, V] float32: row g's argmax is the target's pick for position
    ``pos + g + 1``.  Rows past ``max_seq_len`` (a slot finishing at the
    context edge mid-chunk) write into the trash block instead of
    clamping onto live KV; rejected rows' K/V stay past the accepted
    frontier, masked until a later write overwrites them."""
    b, g = tokens.shape
    d = cfg.head_dim
    bs = transformer.kv_shards(pool)[0]["k"].shape[3]
    max_pos = cfg.max_seq_len - 1
    x = quant.embed_rows(model.embed, tokens)                     # [B, G, H]
    positions = pos.long()[:, None] + torch.arange(g, device=tokens.device)[None]
    wpos = torch.clamp(positions, max=max_pos)
    sin, cos = transformer.rope_sincos(wpos, d, cfg.rope_theta)
    blk = torch.where(positions <= max_pos,
                      tables.long().gather(1, wpos // bs),
                      torch.full_like(positions, TRASH_BLOCK))     # [B, G]
    off = wpos % bs

    def attn(lp, h_in, i, sh):
        p, ins = sh.kv, sh.ins
        q, k, v = quant.matmul_many(h_in, (lp.wq, lp.wk, lp.wv))
        q = q.reshape(b, g, sh.nq, d)
        k = k.reshape(b, g, sh.nkv, d)
        v = v.reshape(b, g, sh.nkv, d)
        q = transformer.apply_rope(q, ins["sin"], ins["cos"])
        k = transformer.apply_rope(k, ins["sin"], ins["cos"])
        quant.put_kv_rows(p, i, (slice(None), ins["blk"], ins["off"]),
                          k.permute(2, 0, 1, 3),
                          v.permute(2, 0, 1, 3))               # [nkv, B, G, d]
        out = attention.ragged_verify(q, p["k"][i], p["v"][i], ins["tables"],
                                      ins["pos"],
                                      *transformer.layer_scales(p, i))
        return out.reshape(b, g, sh.nq * d)

    x = transformer.run_layers(cfg, model, x, attn, pool, {
        "sin": sin, "cos": cos, "blk": blk, "off": off, "tables": tables,
        "pos": pos})
    hidden = transformer.rms_norm(x, model.final_ln, cfg.norm_eps)
    return transformer.logits_from_hidden(model, hidden)
