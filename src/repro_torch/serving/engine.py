"""Multi-position decode engine over the port's transformer.

The engine executes the paper's abstraction directly: a decode forward
that processes N positions (Eq. 2) over a pre-allocated cache, in the
single-request mode (``prefill`` / ``decode_step``) or the scheduler's
slotted mode (``prefill_slots`` / ``decode_slots`` / ``commit_slots``),
over a dense per-slot cache or a paged block pool; ``peek_step`` /
``commit`` split a single-request forward from its commit for the
parallel-decoding drivers.  The NFP budget
(``core.nfp.parallelism_budget``) sizes the positions per forward.

KV writes are IN PLACE (the reference returns a new cache and commits
rows selectively).  For attention caches that is equivalent: a row that
advances 0 only wrote at or past its committed length, which every
causal mask hides until a later forward overwrites it.  Prefill writes
only the rows of its group, so rows outside it stay bitwise unchanged.

Recurrent SSM state has no length mask, so it is never written in place
by a decode forward: ``forward`` returns new states, and the engine
copies them into its cache's state tensors on commit (``commit_slots``
keeps the old state of every row that advanced 0).  The cache's tensors
are allocated once and never rebound.  SSM models prefill at
exact prompt lengths (bucket padding would run through the recurrence)
and every prefill starts from a zero state, so a reused slot carries
nothing of its previous request.  They serve on the dense cache only.

On a CUDA engine ``decode_slots`` replays a captured CUDA graph per
decode width (``serving.capture``; ``capture=False`` keeps the eager
forward).  Prefill and the single-request drivers stay eager.  The
captured step reads the tokens, ``slot_lens``, the block tables and the
cache from static buffers, so every update to them is an in-place copy;
its outputs are valid until the next ``decode_slots``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.arch import LAYER_SSM, ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.granularity import GranularitySpec
from repro_torch.core.hardware import H100, HardwareSpec
from repro_torch.core.nfp import parallelism_budget
from repro_torch.models.transformer import (check_ported, forward, has_ssm,
                                            init_cache, init_paged_cache,
                                            make_segments)
from repro_torch.serving.capture import DecodeGraphs
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
    ``use_kernel`` and ``capture`` (``decode_slots`` replays a CUDA graph
    per width) default to True exactly when the device is CUDA, and
    ``capture=True`` elsewhere raises.  ``params`` must already live on
    the device."""

    cfg: ArchConfig
    params: Dict
    batch: int
    max_len: int
    hardware: HardwareSpec = H100
    use_kernel: Optional[bool] = None
    paged: Optional[PagedKVConfig] = None
    device: DeviceLike = None
    capture: Optional[bool] = None
    cache: Dict = field(init=False)
    # committed positions of the single-request drivers: a HOST int, read
    # by every step's budget decision without touching the device
    cache_len: int = field(init=False, default=0)
    # (b, d) final-norm hidden state of the last prompt position of the
    # last ``prefill`` (MTP proposes from it)
    last_hidden: Optional[Tensor] = field(init=False, default=None)

    def __post_init__(self):
        check_ported(self.cfg)
        self.device = resolve_device(self.device)
        if self.use_kernel is None:
            self.use_kernel = self.device.type == "cuda"
        if self.capture is None:
            self.capture = self.device.type == "cuda"
        self.graphs = (DecodeGraphs(self.device, self._decode_forward)
                       if self.capture else None)
        table = self.params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine "
                             f"on {self.device}")
        self.dtype = table.dtype               # caches hold the params' type
        self.manager: Optional[BlockManager] = None
        self.recurrent = has_ssm(self.cfg)     # no paging (init_paged_cache)
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
        attn = self.cfg.attention
        self.gran = GranularitySpec.for_backend(
            self.cfg.ffn.n_experts,
            head_dim=attn.head_dim if attn is not None else 128,
            kv_page=(self.paged.block_size if self.paged else 0))
        # per-slot committed lengths: ``slot_lens`` rides the decode
        # forwards (device int32), ``slot_lens_host`` is its host mirror
        # — every update comes from host values, so budget and admission
        # math never wait on the device
        self.slot_lens = torch.zeros((self.batch,), dtype=torch.int32,
                                     device=self.device)
        self.slot_lens_host = np.zeros((self.batch,), np.int64)
        # device copy of the block tables (a static buffer), refreshed
        # from the BlockManager's host tables when they change
        self._bt_device: Optional[Tensor] = None
        self._bt_stale = True
        self._peeked = 0                       # positions of the last peek
        self.prefill_log: List[Dict] = []

    def _require_dense(self, what: str) -> None:
        if self.manager is not None:
            raise RuntimeError(
                f"{what} drives the aligned dense cache; a paged engine "
                "serves through prefill_slots/decode_slots/commit_slots")

    def _device_tables(self) -> Tensor:
        """Device copy of the block tables: one buffer, copied into from
        the host tables after every admission, release and preemption."""
        if self._bt_stale:
            tables = torch.from_numpy(self.manager.device_tables())
            if self._bt_device is None:
                self._bt_device = tables.to(self.device)
            else:
                self._bt_device.copy_(tables)
            self._bt_stale = False
        return self._bt_device

    def _adopt_states(self, new_cache: Dict,
                      keep: Optional[Tensor] = None) -> None:
        """Copy a forward's new SSM states into the cache's own state
        tensors (rows where ``keep`` (b,) is False keep their old state).
        Attention leaves need nothing: the forward wrote them in place."""
        for (kind, _), old, new in zip(make_segments(self.cfg),
                                       self.cache["segments"],
                                       new_cache["segments"]):
            if kind != LAYER_SSM:
                continue
            for k, v in new.items():
                if keep is not None:
                    v = torch.where(
                        keep.view((1, -1) + (1,) * (v.dim() - 2)), v, old[k])
                old[k].copy_(v)

    def _tokens(self, toks) -> Tensor:
        return torch.as_tensor(np.array(toks, np.int64),
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
        """tokens: (b, prompt_len).  Returns last-position logits and keeps
        the last position's final-norm hidden state in ``last_hidden``."""
        self._require_dense("prefill")
        logits, new_cache, _, hidden = forward(
            self.params, self.cfg, {"tokens": tokens}, mode="prefill",
            cache=self.cache, use_kernel=self.use_kernel)
        self._adopt_states(new_cache)
        self.cache_len = int(tokens.shape[1])
        self.last_hidden = hidden[:, -1]
        return logits[:, -1]

    def decode_step(self, tokens: Tensor, advance: Optional[int] = None
                    ) -> Tensor:
        """One multi-position decode forward over N = tokens.shape[1]
        positions, committing ``advance`` of them (default all N).  A model
        with recurrent state commits all N or none: its state after a
        part of the block is not kept."""
        self._require_dense("decode_step")
        n = tokens.shape[1]
        adv = n if advance is None else int(advance)
        if self.recurrent and adv not in (0, n):
            raise ValueError(
                f"{self.cfg.name}: committing {adv} of {n} positions needs "
                "the recurrent state after each position, which is not "
                "kept")
        logits, new_cache, _, _ = forward(
            self.params, self.cfg, {"tokens": tokens}, mode="decode",
            cache=self.cache, cache_len=self.cache_len,
            use_kernel=self.use_kernel)
        if adv > 0:
            self._adopt_states(new_cache)
        self.cache_len += adv
        return logits

    def peek_step(self, tokens: Tensor) -> Tuple[Tensor, Dict, Tensor]:
        """A decode forward that commits nothing (verification and
        refinement forwards): K/V of the N positions land in the cache in
        place from ``cache_len`` on, where the mask hides them until
        ``commit`` advances over them or a later forward overwrites them;
        SSM states come back new.  Returns (logits, new_cache, hidden)."""
        self._require_dense("peek_step")
        logits, new_cache, _, hidden = forward(
            self.params, self.cfg, {"tokens": tokens}, mode="decode",
            cache=self.cache, cache_len=self.cache_len,
            use_kernel=self.use_kernel)
        self._peeked = tokens.shape[1]
        return logits, new_cache, hidden

    def commit(self, new_cache: Dict, n_accepted: int) -> None:
        """Advance over the first ``n_accepted`` positions of the last
        ``peek_step``.  Their K/V are in the cache already; a recurrent
        state is adopted only after all of the peeked positions (its state
        after a part of them is not kept, so a partial commit raises)."""
        self._require_dense("commit")
        n = int(n_accepted)
        if self.recurrent and n not in (0, self._peeked):
            raise ValueError(
                f"{self.cfg.name}: committing {n} of {self._peeked} "
                "positions needs the recurrent state after each position, "
                "which is not kept")
        if n > 0:
            self._adopt_states(new_cache)
        self.cache_len += n

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
        prompt, so causality keeps them out of every prompt position (an
        SSM model's groups have no pad positions)."""
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
        if self.recurrent:                 # exact lengths, shortest first
            by_len: Dict[int, Dict[int, np.ndarray]] = {}
            for s in toks:
                by_len.setdefault(lens[s], {})[s] = toks[s]
            groups = sorted(by_len.items())
        else:
            groups = [(self.prefill_bucket(max(lens.values())), toks)]
        kinds = [kind for kind, _ in make_segments(self.cfg)]
        out: Dict[int, Tuple[Tensor, Tensor]] = {}
        for width, group in groups:
            rows, logits, scratch, hidden = self._prefill_scratch(group,
                                                                  width)
            idx = torch.as_tensor(rows, device=self.device)
            for kind, seg, sseg in zip(kinds, self.cache["segments"],
                                       scratch["segments"]):
                for key, leaf in seg.items():
                    if kind == LAYER_SSM:      # (layers, batch, ...) state
                        leaf[:, idx] = sseg[key]
                    else:                      # (layers, batch, seq, ...)
                        leaf[:, idx, :width] = sseg[key]
            for i, s in enumerate(rows):
                self._set_slot_len(s, lens[s])
                out[s] = (logits[i, lens[s] - 1], hidden[i, lens[s] - 1])
            self.prefill_log.append({"slots": rows, "bucket": width,
                                     "computed_tokens": sum(
                                         lens[s] for s in rows)})
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
        self._bt_stale = True                  # tables changed
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
            # length (or into the trash page), which no mask reads back;
            # a prefill, so eager (its widths are prompt buckets)
            logits, _, hidden = self._decode_forward(self._tokens(grid))
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

    def prefill_slot(self, slot: int, prompt: np.ndarray) -> Tensor:
        """Prefill ONE cache slot; returns its last-position logits."""
        return self.prefill_slots({slot: prompt})[slot][0]

    def decode_slots(self, tokens: Tensor) -> Tuple[Tensor, Dict, Tensor]:
        """Multi-position decode forward over ALL slots at their own
        lengths; K/V land in the cache in place, SSM states come back new
        in the returned cache, and nothing is committed until
        ``commit_slots``.  tokens: (batch, n).  Returns (logits, cache,
        hidden).  With ``use_kernel`` the per-slot lengths (and,
        paged, the block tables) go to ONE decode-attention launch per
        layer for the whole mixed-length batch.

        With ``capture`` this replays the width's CUDA graph: the outputs
        are the graph's and the next ``decode_slots`` overwrites them."""
        if self.manager is not None:
            self._device_tables()              # refresh before a replay
        if self.graphs is None:
            return self._decode_forward(tokens)
        return self.graphs.replay(tokens, self.use_kernel)

    def warm_decode(self, widths) -> None:
        """Capture the decode graphs of ``widths`` ahead of serving or
        timing, so no capture lands inside a timed step (a no-op without
        capture).  A capture's warm-up forward writes K/V at or past every
        slot's committed length, which no mask reads before a later
        forward overwrites it."""
        if self.graphs is None:
            return
        if self.manager is not None:
            self._device_tables()
        for n in widths:
            self.graphs.warm((self.batch, int(n)), self.use_kernel)

    def _decode_forward(self, tokens: Tensor
                        ) -> Tuple[Tensor, Dict, Tensor]:
        """The eager decode forward over the engine's static buffers."""
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
        selection, dense or paged.  SSM states are selected per row, as the
        reference does: a row that advanced 0 keeps its old state (the
        mask goes to the device from the host advances, no sync), and the
        selected states are copied into the cache's own state tensors,
        where the next (captured) forward reads them."""
        adv_host = np.asarray(advances, np.int64)
        self.slot_lens_host = self.slot_lens_host + adv_host
        if self.recurrent:
            self._adopt_states(new_cache, torch.as_tensor(
                adv_host > 0, device=self.device))
        self.slot_lens += torch.as_tensor(adv_host, dtype=torch.int32,
                                          device=self.device)

    def release_slot(self, slot: int) -> None:
        if self.manager is not None:
            self.manager.release(slot)
            self._bt_stale = True              # tables changed
        self._set_slot_len(slot, 0)

    def preempt_slot(self, slot: int) -> None:
        """Evict a slot mid-stream: its paged blocks return to the pool
        (prefix-cache-resident ones stay hit-able) and its length zeroes;
        re-admission recomputes the KV from the request's host context."""
        if self.manager is not None:
            self.manager.preempt(slot)
            self._bt_stale = True              # tables changed
        self._set_slot_len(slot, 0)
