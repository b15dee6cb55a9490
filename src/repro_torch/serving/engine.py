"""Multi-position decode engine over the port's transformer.

The engine executes the paper's abstraction directly: a decode forward
that processes N positions (Eq. 2) over a pre-allocated cache, in the
single-request mode (``prefill`` / ``decode_step``) or the scheduler's
slotted mode (``prefill_slots`` / ``decode_slots`` / ``commit_slots``),
over a dense per-slot cache or a paged block pool.  The NFP budget
(``core.nfp.parallelism_budget``) sizes the positions per forward.

KV writes are IN PLACE (the reference returns a new cache and commits
rows selectively).  For attention-only caches that is equivalent: a row
that advances 0 only wrote at or past its committed length, which every
causal mask hides until a later forward overwrites it.  Prefill writes
only the rows of its group, so rows outside it stay bitwise unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.arch import ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.granularity import GranularitySpec
from repro_torch.core.hardware import H100, HardwareSpec
from repro_torch.core.nfp import parallelism_budget
from repro_torch.models.transformer import (check_ported, forward,
                                            init_cache, init_paged_cache)
from repro_torch.serving.paged import BlockManager, PagedKVConfig

Tensor = torch.Tensor


def greedy_tokens(logits: Tensor) -> Tensor:
    """Greedy token selection ON DEVICE; callers move only the small
    (b, n) int32 result to the host (first maximum wins, as jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _copy_pool_blocks(cache: Dict, src: Tensor, dst: Tensor) -> None:
    """Copy pool pages src -> dst across every layer (the COW device op).
    Pool leaves are (layers, n_phys, block, ...): index axis 1."""
    for seg in cache["segments"]:
        for pool in seg.values():
            pool[:, dst] = pool[:, src]


def _scatter_prefill(cache: Dict, scratch: Dict, flat_idx: Tensor,
                     rows: Tensor, cols: Tensor) -> None:
    """Move freshly prefilled KV from the dense scratch cache into pool
    pages: scratch[(row, col)] -> pool_flat[flat_idx], per layer."""
    for seg, sseg in zip(cache["segments"], scratch["segments"]):
        for key, pool in seg.items():
            flat = pool.view((pool.shape[0], pool.shape[1] * pool.shape[2])
                             + tuple(pool.shape[3:]))
            flat[:, flat_idx] = sseg[key][:, rows, cols]


@dataclass
class DecodeEngine:
    """``paged=PagedKVConfig(...)`` puts the slotted serving mode on the
    paged KV cache: ``cache`` becomes a global refcounted block pool
    shared by all slots through the ``BlockManager``'s block tables, and
    admissions whose prompt prefix is resident skip prefill for the
    shared blocks.  The single-request drivers stay dense.

    ``device`` defaults to ``cuda`` (raising where there is none);
    ``use_kernel`` defaults to True exactly when the device is CUDA.
    ``params`` must already live on the device."""

    cfg: ArchConfig
    params: Dict
    batch: int
    max_len: int
    hardware: HardwareSpec = H100
    use_kernel: Optional[bool] = None
    paged: Optional[PagedKVConfig] = None
    device: DeviceLike = None
    cache: Dict = field(init=False)
    # committed positions of the single-request drivers: a HOST int, read
    # by every step's budget decision without touching the device
    cache_len: int = field(init=False, default=0)

    def __post_init__(self):
        check_ported(self.cfg)
        self.device = resolve_device(self.device)
        if self.use_kernel is None:
            self.use_kernel = self.device.type == "cuda"
        table = self.params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine "
                             f"on {self.device}")
        self.dtype = table.dtype               # caches hold the params' type
        self.manager: Optional[BlockManager] = None
        if self.paged is not None:
            bs = self.paged.block_size
            n_blocks = (self.paged.n_blocks if self.paged.n_blocks
                        else self.batch * (self.max_len // max(bs, 1)))
            self.manager = BlockManager(self.batch, self.max_len, bs,
                                        n_blocks, self.paged.prefix_cache)
            self.cache = init_paged_cache(self.cfg, self.manager.n_phys, bs,
                                          self.dtype, self.device)
        else:
            self.cache = init_cache(self.cfg, self.batch, self.max_len,
                                    self.dtype, self.device)
        self.gran = GranularitySpec.for_backend(
            self.cfg.ffn.n_experts, head_dim=self.cfg.attention.head_dim,
            kv_page=(self.paged.block_size if self.paged else 0))
        # per-slot committed lengths: ``slot_lens`` rides the decode
        # forwards (device int32), ``slot_lens_host`` is its host mirror
        # — every update comes from host values, so budget and admission
        # math never wait on the device
        self.slot_lens = torch.zeros((self.batch,), dtype=torch.int32,
                                     device=self.device)
        self.slot_lens_host = np.zeros((self.batch,), np.int64)
        self._bt_device: Optional[Tensor] = None
        self.prefill_log: List[Dict] = []

    def _require_dense(self, what: str) -> None:
        if self.manager is not None:
            raise RuntimeError(
                f"{what} drives the aligned dense cache; a paged engine "
                "serves through prefill_slots/decode_slots/commit_slots")

    def _device_tables(self) -> Tensor:
        """Device copy of the block tables, cached between admissions."""
        if self._bt_device is None:
            self._bt_device = torch.as_tensor(self.manager.device_tables(),
                                              device=self.device)
        return self._bt_device

    def _tokens(self, toks) -> Tensor:
        return torch.as_tensor(np.asarray(toks), dtype=torch.long,
                               device=self.device)

    # ------------------------------------------------------------------
    def nfp_budget(self, eps: float = 0.2, routing: str = "balanced",
                   ell: Optional[int] = None) -> int:
        """Near-free position budget for the current state (Sec. 6);
        pure host math."""
        if ell is None:
            ell = self.cache_len
        ell = max(int(ell), 1)
        return parallelism_budget(self.cfg, self.hardware, self.gran,
                                  self.batch, ell, eps, routing)

    # ------------------------------------------------------------------
    # single-request mode (aligned rows, dense cache)
    # ------------------------------------------------------------------
    def prefill(self, tokens: Tensor) -> Tensor:
        """tokens: (b, prompt_len).  Returns last-position logits."""
        self._require_dense("prefill")
        logits, _, _, _ = forward(self.params, self.cfg, {"tokens": tokens},
                                  mode="prefill", cache=self.cache,
                                  use_kernel=self.use_kernel)
        self.cache_len = int(tokens.shape[1])
        return logits[:, -1]

    def decode_step(self, tokens: Tensor, advance: Optional[int] = None
                    ) -> Tensor:
        """One multi-position decode forward over N = tokens.shape[1]
        positions, committing ``advance`` of them (default all N)."""
        self._require_dense("decode_step")
        logits, _, _, _ = forward(self.params, self.cfg, {"tokens": tokens},
                                  mode="decode", cache=self.cache,
                                  cache_len=self.cache_len,
                                  use_kernel=self.use_kernel)
        self.cache_len += tokens.shape[1] if advance is None else int(advance)
        return logits

    def greedy_generate(self, prompt: Tensor, steps: int) -> Tensor:
        """Plain autoregressive baseline (N=1 per forward) — the
        losslessness oracle of every serve mode."""
        logits = self.prefill(prompt)
        last = torch.argmax(logits, dim=-1)[:, None]
        out = [last]
        for _ in range(steps - 1):
            logits = self.decode_step(last)
            last = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out.append(last)
        return torch.cat(out, dim=1)

    # ------------------------------------------------------------------
    # slotted multi-request mode (serving.scheduler)
    # ------------------------------------------------------------------
    def _set_slot_len(self, slot: int, value: int) -> None:
        """Update one slot's length on device AND in the host mirror."""
        self.slot_lens[slot] = value
        self.slot_lens_host[slot] = int(value)

    def prefill_bucket(self, p: int) -> int:
        """Power-of-two prompt-length bucket (floor 8, ceiling max_len)."""
        b = 8
        while b < p:
            b *= 2
        return min(b, self.max_len)

    def _prefill_scratch(self, toks: Dict[int, np.ndarray], width: int):
        """Prefill the rows ``sorted(toks)`` (right-padded to ``width``)
        into a fresh dense scratch cache.  Pad positions sit after each
        prompt, so causality keeps them out of every prompt position."""
        rows = sorted(toks)
        grid = np.zeros((len(rows), width), np.int64)
        for i, s in enumerate(rows):
            grid[i, :len(toks[s])] = toks[s]
        scratch = init_cache(self.cfg, len(rows), width, self.dtype,
                             self.device)
        logits, scratch, _, hidden = forward(
            self.params, self.cfg, {"tokens": self._tokens(grid)},
            mode="prefill", cache=scratch, use_kernel=self.use_kernel)
        return rows, logits, scratch, hidden

    def prefill_slots(self, prompts: Dict[int, np.ndarray],
                      reserve: Optional[Dict[int, int]] = None
                      ) -> Dict[int, Tuple[Tensor, Tensor]]:
        """Bucketed multi-slot prefill: fill MANY cache slots in one
        forward.  ``prompts``: {slot: (p,) tokens}.  On a paged engine
        ``reserve`` caps each slot's block reservation (default max_len)
        and prefix-cache hits skip the shared blocks
        (``_prefill_slots_paged``).

        Returns {slot: (last-prompt-position logits, hidden)}."""
        toks = {s: np.asarray(p, np.int64).ravel() for s, p in prompts.items()}
        lens = {s: len(t) for s, t in toks.items()}
        for s, p in lens.items():
            if p < 1:
                raise ValueError(f"slot {s}: empty prompt")
            if p > self.max_len:
                raise ValueError(
                    f"slot {s}: prompt of {p} tokens exceeds the engine's "
                    f"max_len={self.max_len}; it cannot be prefilled "
                    "(admission should have rejected it)")
        if self.manager is not None:
            return self._prefill_slots_paged(toks, lens, reserve or {})
        width = self.prefill_bucket(max(lens.values()))
        rows, logits, scratch, hidden = self._prefill_scratch(toks, width)
        idx = torch.as_tensor(rows, device=self.device)
        for seg, sseg in zip(self.cache["segments"], scratch["segments"]):
            for key, leaf in seg.items():
                leaf[:, idx, :width] = sseg[key]
        out: Dict[int, Tuple[Tensor, Tensor]] = {}
        for i, s in enumerate(rows):
            self._set_slot_len(s, lens[s])
            out[s] = (logits[i, lens[s] - 1], hidden[i, lens[s] - 1])
        self.prefill_log.append({"slots": rows, "bucket": width,
                                 "computed_tokens": sum(lens.values())})
        return out

    def _prefill_slots_paged(self, toks: Dict[int, np.ndarray],
                             lens: Dict[int, int], reserve: Dict[int, int]
                             ) -> Dict[int, Tuple[Tensor, Tensor]]:
        """Paged admission + prefill.

        Per slot the BlockManager attaches resident prefix blocks, copies
        the divergence block on write, and allocates the rest of the
        reservation.  NO-HIT slots prefill into a dense scratch cache whose
        KV is then scattered into their pages; HIT slots run only the
        divergent suffix, as ONE decode-shape forward at per-row offsets
        writing straight into the pool (through the paged kernel with
        ``use_kernel``).  Full prompt blocks register in the prefix cache
        afterwards."""
        mgr = self.manager
        plans = {}
        for s in sorted(toks):
            r = min(int(reserve.get(s, self.max_len)), self.max_len)
            plans[s] = mgr.admit(s, toks[s].tolist(), max(r, lens[s]))
        self._bt_device = None                 # tables changed
        cows = [c for s in sorted(toks) for c in plans[s].cow_copies]
        if cows:
            _copy_pool_blocks(
                self.cache, torch.as_tensor([c[0] for c in cows],
                                            device=self.device),
                torch.as_tensor([c[1] for c in cows], device=self.device))
        full = sorted(s for s in toks if plans[s].cached_len == 0)
        hits = sorted(s for s in toks if plans[s].cached_len > 0)
        out: Dict[int, Tuple[Tensor, Tensor]] = {}
        bs = mgr.block_size
        if full:
            width = self.prefill_bucket(max(lens[s] for s in full))
            _, logits, scratch, hidden = self._prefill_scratch(
                {s: toks[s] for s in full}, width)
            rows, cols, flats = [], [], []
            for i, s in enumerate(full):
                pos = np.arange(lens[s])
                page = mgr.tables[s, pos // bs].astype(np.int64)
                rows.append(np.full(lens[s], i, np.int64))
                cols.append(pos)
                flats.append(page * bs + pos % bs)
            _scatter_prefill(self.cache, scratch,
                             *(torch.as_tensor(np.concatenate(a),
                                               device=self.device)
                               for a in (flats, rows, cols)))
            for i, s in enumerate(full):
                self._set_slot_len(s, lens[s])
                out[s] = (logits[i, lens[s] - 1], hidden[i, lens[s] - 1])
            self.prefill_log.append({"slots": full, "bucket": width,
                                     "cached_tokens": 0,
                                     "computed_tokens": sum(
                                         lens[s] for s in full)})
        if hits:
            suf = {s: lens[s] - plans[s].cached_len for s in hits}
            for s in hits:
                self._set_slot_len(s, plans[s].cached_len)
            width = self.prefill_bucket(max(suf.values()))
            grid = np.zeros((self.batch, width), np.int64)
            for s in hits:
                grid[s, :suf[s]] = toks[s][plans[s].cached_len:]
            # rows outside the hit group write past their own committed
            # length (or into the trash page), which no mask reads back
            logits, _, hidden = self.decode_slots(self._tokens(grid))
            for s in hits:
                self._set_slot_len(s, lens[s])
                out[s] = (logits[s, suf[s] - 1], hidden[s, suf[s] - 1])
            self.prefill_log.append({
                "slots": hits, "bucket": width,
                "cached_tokens": sum(plans[s].cached_len for s in hits),
                "computed_tokens": sum(suf.values())})
        for s in sorted(toks):
            mgr.register_prompt(s, toks[s].tolist())
        return out

    def decode_slots(self, tokens: Tensor) -> Tuple[Tensor, Dict, Tensor]:
        """Multi-position decode forward over ALL slots at their own
        lengths; K/V land in the cache in place but lengths do not move
        until ``commit_slots``.  tokens: (batch, n).  Returns (logits,
        cache, hidden).  With ``use_kernel`` the per-slot lengths (and,
        paged, the block tables) go to ONE decode-attention launch per
        layer for the whole mixed-length batch."""
        tables = self._device_tables() if self.manager is not None else None
        logits, cache, _, hidden = forward(
            self.params, self.cfg, {"tokens": tokens}, mode="decode",
            cache=self.cache, cache_len=self.slot_lens,
            use_kernel=self.use_kernel, block_tables=tables)
        return logits, cache, hidden

    def commit_slots(self, new_cache: Dict, advances) -> None:
        """Commit per slot: lengths advance by ``advances`` (HOST values:
        they also feed ``slot_lens_host``).  The K/V of the forward are in
        the cache already: a row that advanced 0 (an inactive slot or a
        fully rejected block) only wrote at or past its committed length,
        positions every mask skips until a later forward overwrites them —
        so adopting the cache wholesale equals the reference's per-row
        selection, dense or paged."""
        adv_host = np.asarray(advances, np.int64)
        self.slot_lens_host = self.slot_lens_host + adv_host
        self.cache = new_cache
        self.slot_lens += torch.as_tensor(adv_host, dtype=torch.int32,
                                          device=self.device)

    def release_slot(self, slot: int) -> None:
        if self.manager is not None:
            self.manager.release(slot)
            self._bt_device = None             # tables changed
        self._set_slot_len(slot, 0)

    def preempt_slot(self, slot: int) -> None:
        """Evict a slot mid-stream: its paged blocks return to the pool
        (prefix-cache-resident ones stay hit-able) and its length zeroes;
        re-admission recomputes the KV from the request's host context."""
        if self.manager is not None:
            self.manager.preempt(slot)
            self._bt_device = None             # tables changed
        self._set_slot_len(slot, 0)
