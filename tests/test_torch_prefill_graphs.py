"""The engine's captured forwards on the CPU, against the reference.

On the card every forward of a ``DecodeEngine`` replays a CUDA graph
(``serving.capture``).  Nothing is captured on the CPU: there the engine
runs the same forwards eagerly (``serving.capture.EagerGraphs``) over
the same static input buffers, the (batch, width) prefill grid with its
row flags and scratch cache, and the device ``cache_len`` buffer of the
single-request drivers, its outputs rewritten at every run of a key and
cloned where a caller keeps them.  Held against the reference's ``DecodeEngine`` on the same
weights in float32 (``LOGIT_TOL``):

- ``prefill`` / ``decode_step`` / ``peek_step`` / ``commit`` with
  ``cache_len`` on the device, for reduced stablelm_3b and reduced
  mixtral_8x22b (sliding window 8, run past it), a rewind of
  ``cache_len`` included (what the speculative driver's draft engine
  does);
- the device ``cache_len`` through the sliding-window ring buffer, MLA
  and the hybrid segments: the forward bitwise the host int's, and no
  host read of any tensor on the way;
- ``prefill_slots`` over the (batch, width) grid: the group's logits and
  hidden states, the cache rows outside the group unchanged, the slot
  lengths and ``prefill_log`` equal, dense and paged (with a prefix hit)
  for stablelm_3b and at exact lengths for falcon_mamba_7b;
- the paged scatter padded to a power of two against the unpadded one;
- ``warm_prefill`` captures without touching the cache.
"""
from __future__ import annotations

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

import repro.serving.engine as ref_engine_mod  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.hardware import TPU_V5E  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.models.transformer import init_paged_cache as ref_paged  # noqa: E402
from repro.serving import DecodeEngine as RefEngine  # noqa: E402
from repro.serving import PagedKVConfig as RefPaged  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.hardware import HardwareSpec  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.models import init_model as port_init_model  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.serving import DecodeEngine, PagedKVConfig  # noqa: E402
from repro_torch.serving.engine import _scatter_prefill, pad_scatter  # noqa: E402

MAX_LEN, SLOTS, BLOCK = 64, 4, 8
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)      # float32 rounding, two layers
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))
#: the tensor methods that read a value back to the host
HOST_READS = {"__bool__", "__int__", "__float__", "__index__", "item",
              "tolist", "numpy", "cpu"}


class NoHostRead(TorchFunctionMode):
    """Raises on any tensor value read back to the host."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in HOST_READS:
            raise AssertionError(f"host read: {func.__name__}")
        return func(*args, **(kwargs or {}))


_MODELS = {}


def _model(arch):
    """(reference cfg, port cfg, reference params, port params), f32."""
    if arch not in _MODELS:
        cfg = get_config(arch, reduced=True)
        params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
        _MODELS[arch] = (cfg, port_config(arch, reduced=True), params,
                         params_from_jax(jax.tree.map(np.asarray, params)))
    return _MODELS[arch]


def _engine(pcfg, port, batch, paged=False):
    return DecodeEngine(pcfg, port, batch=batch, max_len=MAX_LEN,
                        hardware=HW, device="cpu",
                        paged=PagedKVConfig(block_size=BLOCK) if paged
                        else None)


def _ref_engine(cfg, params, batch, paged=False):
    if paged:
        n_phys = batch * MAX_LEN // BLOCK + 1
        return RefEngine(cfg, params, batch=batch, max_len=MAX_LEN,
                         paged=RefPaged(block_size=BLOCK),
                         cache=ref_paged(cfg, n_phys, BLOCK,
                                         dtype=jnp.float32))
    return RefEngine(cfg, params, batch=batch, max_len=MAX_LEN,
                     cache=ref_init_cache(cfg, batch, MAX_LEN,
                                          dtype=jnp.float32))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# single-request drivers, cache_len on the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm_3b", "mixtral_8x22b"],
                         ids=["stablelm", "swa"])
def test_single_request_matches_reference(arch):
    """prefill, decode_step (all committed, one of three), peek_step +
    commit and a rewound ``cache_len``: logits within LOGIT_TOL of the
    reference's, ``cache_len`` the reference's and the device buffer the
    value the forward read; one key per (b, s) prefill and (b, n)
    decode; the prefill's logits and ``last_hidden`` outlive the later
    forwards."""
    cfg, pcfg, params, port = _model(arch)
    ref = _ref_engine(cfg, params, 2)
    eng = _engine(pcfg, port, 2)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (2, 7))
    want = ref.prefill(jnp.asarray(prompt, jnp.int32))
    got = eng.prefill(torch.as_tensor(prompt))
    _close(got, want)
    _close(eng.last_hidden, ref.last_hidden)
    kept = (got, eng.last_hidden)
    copies = (got.clone(), eng.last_hidden.clone())

    def step(kind, n, advance=None):
        toks = rng.integers(0, cfg.vocab_size, (2, n))
        if kind == "decode":
            want = ref.decode_step(jnp.asarray(toks, jnp.int32), advance)
            got = eng.decode_step(torch.as_tensor(toks), advance)
        else:
            want, new_ref, _ = ref.peek_step(jnp.asarray(toks, jnp.int32))
            ref.commit(new_ref, advance)
            got, new, _ = eng.peek_step(torch.as_tensor(toks))
            eng.commit(new, advance)
        _close(got, want)
        assert eng.cache_len == ref.cache_len
    step("decode", 1)
    step("decode", 1)
    step("peek", 4, 2)
    step("decode", 3, 1)
    # the draft engine's rewind: the host int moves, the buffer follows
    for e in (eng, ref):
        e.cache_len = 9
    step("decode", 2)
    step("decode", 1)
    assert int(eng.cache_len_device) == eng.cache_len - 1
    assert sorted(eng.graphs.steps) == [
        ("decode_single", 2, 1, False), ("decode_single", 2, 2, False),
        ("decode_single", 2, 3, False), ("decode_single", 2, 4, False),
        ("prefill_single", 2, 7, False)]
    # what the caller kept outlives the later forwards
    assert all(torch.equal(a, b) for a, b in zip(kept, copies))


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "minicpm3_4b",
                                  "zamba2_1p2b"],
                         ids=["ring", "mla", "hybrid"])
def test_device_cache_len_reaches_the_model(arch):
    """A decode forward at a 0-d int32 ``cache_len`` tensor: bitwise the
    forward at the host int (logits, hidden, every cache tensor), with
    no tensor read back to the host: the sliding-window ring buffer
    (``swa_ring``), MLA's latent cache, the hybrid segments' shared
    attention and Mamba2 states."""
    pcfg = port_config(arch, reduced=True)
    params = port_init_model(pcfg, torch.Generator().manual_seed(0), "cpu",
                             torch.float32)
    ring = arch == "mixtral_8x22b"
    gen = torch.Generator().manual_seed(1)
    cache = init_cache(pcfg, 2, MAX_LEN, torch.float32, "cpu", swa_ring=ring)
    for leaf in _leaves(cache):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, pcfg.vocab_size, (2, 3)))
    outs = []
    for cache_len in (21, torch.tensor(21, dtype=torch.int32)):
        c = _clone_tree(cache)
        with NoHostRead():
            logits, new, _, hidden = forward(
                params, pcfg, {"tokens": toks}, mode="decode", cache=c,
                cache_len=cache_len, swa_ring=ring)
        outs.append([logits, hidden] + list(_leaves(new)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.clone()


# ---------------------------------------------------------------------------
# the slotted prefill over the (batch, width) grid
# ---------------------------------------------------------------------------

@pytest.fixture
def f32_scratch(monkeypatch):
    """The reference's paged scratch cache in float32."""
    monkeypatch.setattr(ref_engine_mod, "init_cache",
                        functools.partial(ref_init_cache, dtype=jnp.float32))


def _row_state(eng, slots):
    """Slots' own cache contents: dense rows of every leaf, or the pages
    a paged slot's table names over its committed length."""
    out = []
    for s in slots:
        n = int(eng.slot_lens_host[s])
        for leaf in _leaves(eng.cache):
            if eng.manager is None:
                out.append(leaf[:, s].clone())
                continue
            pages = torch.as_tensor(
                eng.manager.tables[s][:-(-n // BLOCK)].astype(np.int64))
            out.append(leaf[:, pages].flatten(1, 2)[:, :n].clone())
    return out


@pytest.mark.parametrize("arch,paged", [("stablelm_3b", False),
                                        ("stablelm_3b", True),
                                        ("falcon_mamba_7b", False)],
                         ids=["stablelm-dense", "stablelm-paged", "falcon"])
def test_slotted_prefill_matches_reference(arch, paged, f32_scratch):
    """Two admissions of two slots each (paged: the second's slot 1
    shares 16 tokens, two pages, with slot 0 and runs only its suffix;
    falcon: exact lengths 5 and 9 in each, one graph per length), then a
    decode step: each admitted slot's (logits, hidden) against the
    reference's, the first group's rows untouched by the second
    admission, slot lengths and ``prefill_log`` the reference's, the
    first admission's returned rows unchanged by the second one's replay
    of the same graphs, and the decode logits the reference's."""
    cfg, pcfg, params, port = _model(arch)
    ref = _ref_engine(cfg, params, SLOTS, paged)
    eng = _engine(pcfg, port, SLOTS, paged)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, 16)
    first = {0: np.concatenate([shared, rng.integers(0, cfg.vocab_size, 3)])
             if paged else rng.integers(0, cfg.vocab_size, 5),
             2: rng.integers(0, cfg.vocab_size, 9)}
    second = {1: np.concatenate([shared, rng.integers(0, cfg.vocab_size, 4)])
              if paged else rng.integers(0, cfg.vocab_size, 5),
              3: rng.integers(0, cfg.vocab_size, 9)}
    kept, before = None, None
    for group in (first, second):
        want = ref.prefill_slots({s: jnp.asarray(p, jnp.int32)
                                  for s, p in group.items()})
        got = eng.prefill_slots(group)
        assert sorted(got) == sorted(group)
        for s in group:
            _close(got[s][0], want[s][0])
            _close(got[s][1], want[s][1])
        if kept is None:
            kept = {s: tuple(t.clone() for t in got[s]) for s in got}
            first_out, before = got, _row_state(eng, sorted(first))
    for s in first:
        assert all(torch.equal(a, b) for a, b in zip(first_out[s], kept[s]))
    after = _row_state(eng, sorted(first))
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    np.testing.assert_array_equal(eng.slot_lens_host, ref.slot_lens_host)
    np.testing.assert_array_equal(eng.slot_lens.numpy(),
                                  np.asarray(ref.slot_lens))
    assert eng.prefill_log == ref.prefill_log
    if paged:
        assert [e["cached_tokens"] for e in eng.prefill_log] == [0, 0, 16]
    toks = rng.integers(0, cfg.vocab_size, (SLOTS, 2))
    want = ref.decode_slots(jnp.asarray(toks, jnp.int32))[0]
    _close(eng.decode_slots(torch.as_tensor(toks))[0], want)
    kinds = sorted({k[0] for k in eng.graphs.steps})
    assert kinds == ["decode", "prefill"]
    if arch.startswith("falcon"):
        assert sorted(k[2] for k in eng.graphs.steps
                      if k[0] == "prefill") == [5, 9]


@pytest.mark.parametrize("n", [3, 8, 11])
def test_padded_scatter_equals_unpadded(n):
    """``pad_scatter`` pads the index arrays to a power of two (at least
    8) with entries aimed at the trash page: the pool after the padded
    scatter equals the unpadded one's on every page but the trash page,
    whose slot holds the first entry's value."""
    gen = torch.Generator().manual_seed(n)
    layers, n_phys, bs = 2, 7, 4
    pool = {"segments": [{"k": torch.randn(layers, n_phys, bs, 2, 3,
                                           generator=gen)}]}
    scratch = {"segments": [{"k": torch.randn(layers, 3, 12, 2, 3,
                                              generator=gen)}]}
    rng = np.random.default_rng(n)
    flats = rng.choice((n_phys - 1) * bs, size=n, replace=False)
    rows, cols = rng.integers(0, 3, n), rng.integers(0, 12, n)
    trash = (n_phys - 1) * bs + 1
    padded = pad_scatter(flats, rows, cols, trash)
    assert len(padded[0]) == max(8, 1 << (n - 1).bit_length())
    assert all(np.array_equal(a[:n], b) for a, b in
               zip(padded, (flats, rows, cols)))
    results = []
    for arrays in ((flats, rows, cols), padded):
        cache = _clone_tree(pool)
        _scatter_prefill(cache, scratch,
                         *(torch.as_tensor(a) for a in arrays))
        results.append(cache["segments"][0]["k"])
    plain, pad = results
    assert torch.equal(plain[:, :-1], pad[:, :-1])
    flat = pad.view(layers, n_phys * bs, 2, 3)
    src = scratch["segments"][0]["k"][:, rows[0], cols[0]]
    assert torch.equal(flat[:, trash], src) == (n < len(padded[0]))


@pytest.mark.parametrize("arch,paged", [("stablelm_3b", False),
                                        ("stablelm_3b", True),
                                        ("falcon_mamba_7b", False)],
                         ids=["stablelm-dense", "stablelm-paged", "falcon"])
def test_warm_prefill_keeps_the_cache(arch, paged):
    """``warm_prefill`` over live slots captures the prefill graphs of
    its widths, which flag no row: a dense cache is left as it was, every
    tensor.  A paged engine with a prefix cache also captures the
    suffix's decode graphs, whose warm-up forwards write K/V only past
    each slot's committed length: the live slots' committed K/V and the
    slot lengths are left as they were."""
    _, pcfg, _, port = _model(arch)
    eng = _engine(pcfg, port, SLOTS, paged)
    rng = np.random.default_rng(4)
    eng.prefill_slots({0: rng.integers(0, pcfg.vocab_size, 11),
                       2: rng.integers(0, pcfg.vocab_size, 5)})

    def state():
        kept = (_row_state(eng, (0, 2)) if paged
                else [t.clone() for t in _leaves(eng.cache)])
        return kept + [eng.slot_lens.clone()]
    before = state()
    widths = (5, 11) if arch.startswith("falcon") else (8, 16, 32)
    eng.warm_prefill(widths)
    assert all(torch.equal(a, b) for a, b in zip(before, state()))
    keys = set(eng.graphs.steps)
    assert {("prefill", SLOTS, w, False) for w in widths} <= keys
    assert ({("decode", w, False) for w in widths} <= keys) == paged
