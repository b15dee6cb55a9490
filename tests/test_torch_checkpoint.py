"""The port's checkpoints, data pipeline, elastic primitives and optimizer
state bridge against the reference's: the on-disk format both ways (a
checkpoint written by either package restores in the other, leaves
equal, bf16 bit for bit), keep-last-k GC, uncommitted directories, the
async writer's snapshot under an in-place update, the synthetic and
binary-shard pipelines batch for batch, and the reference's own tests of
``elastic_mesh``, ``run_with_restarts`` and ``StepWatchdog``.
"""
from __future__ import annotations

import json
import os
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as ref_ckpt  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.data import BinaryShards as RefShards  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import SyntheticLM as RefSynthetic  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.training import AdamWConfig as RefAdamW  # noqa: E402
from repro.training import init_opt_state as ref_init_opt  # noqa: E402
from repro.training import make_train_step as ref_make_step  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.bridge import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.tree import leaves, leaves_with_paths, path_key  # noqa: E402
from repro_torch.data import (BinaryShards, DataConfig,  # noqa: E402
                              SyntheticLM, make_pipeline)
from repro_torch.dist import (StepWatchdog, elastic_mesh,  # noqa: E402
                              run_with_restarts)
from repro_torch.models import init_model as port_init  # noqa: E402
from repro_torch.training import AdamWConfig, init_opt_state, train_step  # noqa: E402


def _state(dtype=torch.bfloat16):
    """A port train state: reduced granite params (bf16 weights, an f32
    router) and its AdamW state after one update, so m and v are
    nonzero."""
    cfg = port_config("granite_moe_3b_a800m", reduced=True)
    params = port_init(cfg, torch.Generator().manual_seed(0), "cpu", dtype)
    opt = init_opt_state(params)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)))
    params, opt, _ = train_step(params, opt, {"tokens": toks}, cfg=cfg,
                                opt_cfg=AdamWConfig(warmup_steps=0))
    return {"params": params, "opt": opt}


def _equal_trees(a, b):
    la, lb = list(leaves_with_paths(a)), list(leaves_with_paths(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x, y), path


def _ref_tree_equal(jtree, ttree):
    """A reference (JAX) tree and a port tree: the same keys, dtypes and
    bits."""
    ref = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        ref[path_key(keys)] = np.asarray(leaf)
    got = {path_key(p): t for p, t in leaves_with_paths(ttree)}
    assert set(got) == set(ref)
    for key, t in got.items():
        want = ref[key]
        if t.dtype == torch.bfloat16:
            assert want.dtype.name == "bfloat16", key
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            assert str(want.dtype) == str(t.numpy().dtype), key
            np.testing.assert_array_equal(t.numpy(), want)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_roundtrip_is_bitwise(tmp_path, dtype):
    """params, master / m / v (f32) and the int32 step come back with
    their dtypes and bits; the metadata comes back as saved."""
    state = _state(dtype)
    ckpt.save(str(tmp_path), 7, state, {"step": 7, "note": "x"})
    restored, meta = ckpt.restore(str(tmp_path), state)
    assert meta == {"step": 7, "note": "x"}
    _equal_trees(restored, state)
    assert restored["opt"]["step"].dtype == torch.int32


def test_on_disk_format(tmp_path):
    """step_%010d / arrays.npz + meta.json + COMMITTED; keys as the
    reference's _path_str joins them; bf16 leaves stored as uint16."""
    state = _state()
    d = ckpt.save(str(tmp_path), 3, state)
    assert os.path.basename(d) == "step_0000000003"
    assert sorted(os.listdir(d)) == ["COMMITTED", "arrays.npz", "meta.json"]
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 3 and meta["metadata"] == {}
    arrays = np.load(os.path.join(d, "arrays.npz"))
    key = "params/segments/[0]/attn/wq"
    assert meta["dtypes"][key] == "bfloat16"
    assert arrays[key].dtype == np.uint16
    assert meta["dtypes"]["opt/step"] == "int32"
    assert meta["dtypes"]["params/segments/[0]/ffn/router"] == "float32"
    assert set(arrays.files) == {path_key(p)
                                 for p, _ in leaves_with_paths(state)}


def test_keep_last_k(tmp_path):
    """The reference's GC test: 4 saves, keep 2."""
    state = {"w": torch.arange(6, dtype=torch.float32)}
    for s in (1, 2, 3, 4):
        state["w"].add_(1)
        ckpt.save(str(tmp_path), s, state, {"note": s}, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000004"]
    restored, meta = ckpt.restore(str(tmp_path), state)
    assert meta["note"] == 4 and torch.equal(restored["w"], state["w"])
    old, _ = ckpt.restore(str(tmp_path), state, step=3)
    assert torch.equal(old["w"], state["w"] - 1)


def test_latest_step_ignores_uncommitted(tmp_path):
    """A step directory without COMMITTED (a crash before the marker) and
    a leftover .tmp, even one holding its marker (a crash before the
    rename, on which the reference's ``latest_step`` raises ValueError),
    are not restorable; an empty directory has none."""
    assert ckpt.latest_step(str(tmp_path / "absent")) is None
    assert ckpt.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(2)})
    ckpt.save(str(tmp_path), 5, {"w": torch.ones(2)})
    (tmp_path / "step_0000000009").mkdir()
    (tmp_path / "step_0000000012.tmp").mkdir()
    (tmp_path / "step_0000000012.tmp" / "COMMITTED").write_text("ok")
    assert ckpt.latest_step(str(tmp_path)) == 5
    with pytest.raises(ValueError):
        ref_ckpt.latest_step(str(tmp_path))
    restored, _ = ckpt.restore(str(tmp_path), {"w": torch.zeros(2)})
    assert torch.equal(restored["w"], torch.ones(2))


def test_restore_places_leaves_on_the_device_asked(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.ones(2)})
    restored, _ = ckpt.restore(str(tmp_path), {"w": torch.zeros(2)},
                               device="cpu")
    assert restored["w"].device == torch.device("cpu")


def test_async_checkpointer_two_saves(tmp_path):
    """The reference's test: the second save waits for the first."""
    state = _state()
    ck = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    ck.save(1, state)
    ck.save(2, state)
    ck.wait()
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_async_snapshot_survives_an_in_place_update(tmp_path, monkeypatch):
    """The writer thread is held until the tree has been updated in place
    (as the optimizer does right after a save); the checkpoint must hold
    the values at save time."""
    go = threading.Event()
    real_save = ckpt_mod.save

    def held_save(*args):
        assert go.wait(timeout=60)
        return real_save(*args)
    monkeypatch.setattr(ckpt_mod, "save", held_save)
    state = _state()
    before = [t.clone() for t in leaves(state)]
    ck = ckpt.AsyncCheckpointer(str(tmp_path))
    ck.save(1, state)
    for t in leaves(state):
        t.add_(1)
    go.set()
    ck.wait()
    restored, _ = ckpt.restore(str(tmp_path), state)
    for got, want in zip(leaves(restored), before):
        assert torch.equal(got, want)


def test_cpu_copy_control():
    """The hazard the snapshot copies against: ``.cpu()`` of a CPU tensor
    is the same storage, so an in-place update shows through it."""
    t = torch.zeros(3)
    alias = t.cpu()
    t.add_(1)
    assert torch.equal(alias, t)
    copy = t.detach().to("cpu", copy=True)
    t.add_(1)
    assert not torch.equal(copy, t)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_checkpoint_restores_in_reference(tmp_path, dtype):
    """A port-written train state restored by ``repro.checkpoint.restore``
    into the reference's tree of the same structure: equal leaves."""
    cfg = get_config("granite_moe_3b_a800m", reduced=True)
    jparams = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.dtype(dtype))
    jstate = {"params": jparams, "opt": ref_init_opt(jparams)}
    state = _state(getattr(torch, dtype))
    ckpt.save(str(tmp_path), 4, state, {"step": 4})
    restored, meta = ref_ckpt.restore(str(tmp_path), jstate)
    assert meta == {"step": 4}
    _ref_tree_equal(restored, state)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reference_checkpoint_restores_in_port(tmp_path, dtype):
    """The reference's state after one jitted train_step, written by
    ``repro.checkpoint.save``, restored by the port into its own tree:
    equal leaves, bf16 bit for bit."""
    cfg = get_config("granite_moe_3b_a800m", reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.dtype(dtype))
    opt = ref_init_opt(params)
    step = jax.jit(ref_make_step(cfg, RefAdamW(warmup_steps=0)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    params, opt, _ = step(params, opt, {"tokens": jnp.asarray(toks)})
    jstate = {"params": params, "opt": opt}
    ref_ckpt.save(str(tmp_path), 1, jstate, {"step": 1})
    target = _state(getattr(torch, dtype))
    restored, meta = ckpt.restore(str(tmp_path), target)
    assert meta == {"step": 1} and int(restored["opt"]["step"]) == 1
    _ref_tree_equal(jstate, restored)


def test_opt_state_from_jax(tmp_path):
    """The reference's AdamW state (numpy leaves) as the port's: the same
    trees, an int32 step; a non-AdamW tree is refused."""
    cfg = get_config("stablelm_3b", reduced=True)
    params = init_model(jax.random.PRNGKey(0), cfg)
    opt = jax.tree.map(np.asarray, ref_init_opt(params))
    opt["step"] = np.asarray(3, np.int32)
    got = opt_state_from_jax(opt)
    _ref_tree_equal(opt, got)
    assert got["step"].shape == () and int(got["step"]) == 3
    assert set(got["master"]) == set(params_from_jax(
        jax.tree.map(np.asarray, params)))
    with pytest.raises(ValueError, match="AdamW"):
        opt_state_from_jax({"master": opt["master"]})


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(256, 32, 8, 0),
                                                  (1000, 17, 3, 7)])
def test_synthetic_lm_is_the_reference_bitwise(vocab, seq, batch, seed):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    ref = iter(RefSynthetic(RefDataConfig(**kw)))
    got = iter(SyntheticLM(DataConfig(**kw)))
    for _ in range(3):
        a, b = next(ref), next(got)
        assert a.keys() == b.keys() == {"tokens"}
        assert b["tokens"].dtype == a["tokens"].dtype == np.int32
        np.testing.assert_array_equal(b["tokens"], a["tokens"])


@pytest.mark.parametrize("process_index,num_processes", [(0, 1), (1, 2)])
def test_binary_shards_are_the_reference_bitwise(tmp_path, process_index,
                                                 num_processes):
    """Three shards, split over hosts, windows permuted per file from
    seed + process_index: the first 3 batches equal the reference's."""
    rng = np.random.default_rng(1)
    for i in range(3):
        arr = rng.integers(0, 100, 4096 + 300 * i).astype(np.uint16)
        (tmp_path / f"shard_{i}.bin").write_bytes(arr.tobytes())
    kw = dict(vocab_size=100, seq_len=15, global_batch=4, seed=3,
              path=str(tmp_path))
    ref = iter(RefShards(RefDataConfig(**kw), process_index, num_processes))
    got = iter(BinaryShards(DataConfig(**kw), process_index, num_processes))
    for _ in range(3):
        a, b = next(ref), next(got)
        assert b["tokens"].shape == (4, 15) and b["tokens"].max() < 100
        np.testing.assert_array_equal(b["tokens"], a["tokens"])


def test_make_pipeline_picks_the_source(tmp_path):
    (tmp_path / "shard_0.bin").write_bytes(
        (np.arange(4096, dtype=np.uint16) % 100).tobytes())
    cfg = DataConfig(vocab_size=100, seq_len=15, global_batch=4,
                     path=str(tmp_path))
    assert next(make_pipeline(cfg))["tokens"].shape == (4, 15)
    syn = DataConfig(vocab_size=100, seq_len=15, global_batch=4)
    np.testing.assert_array_equal(next(make_pipeline(syn))["tokens"],
                                  next(iter(SyntheticLM(syn)))["tokens"])
    with pytest.raises(FileNotFoundError):
        BinaryShards(cfg, process_index=1, num_processes=2)


# ---------------------------------------------------------------------------
# elastic primitives (the reference's tests)
# ---------------------------------------------------------------------------

def test_elastic_mesh_factorization():
    assert elastic_mesh(512) == ((2, 16, 16), ("pod", "data", "model"))
    assert elastic_mesh(256) == ((16, 16), ("data", "model"))
    shape, _ = elastic_mesh(384)
    assert int(np.prod(shape)) == 384
    assert elastic_mesh(1) == ((1, 1), ("data", "model"))
    assert elastic_mesh(12) == ((1, 12), ("data", "model"))
    with pytest.raises(ValueError):
        elastic_mesh(0)


def test_run_with_restarts_recovers():
    calls = {"n": 0, "restored": 0}

    def step_fn(step):
        calls["n"] += 1
        if step == 3 and calls["restored"] == 0:
            raise RuntimeError("injected node failure")

    def restore_fn():
        calls["restored"] += 1
        return 2

    assert run_with_restarts(step_fn, 0, 6, restore_fn,
                             retry_transient=False) == 6
    assert calls["restored"] == 1


def test_run_with_restarts_retries_then_gives_up():
    """A transient failure is retried in place; a deterministic one
    re-raises after max_restarts rollbacks."""
    seen = []

    def flaky(step):
        seen.append(step)
        if step == 1 and seen.count(1) == 1:
            raise OSError("flaky io")
    assert run_with_restarts(flaky, 0, 3, lambda: 0) == 3
    assert seen == [0, 1, 1, 2]

    def broken(step):
        raise RuntimeError("always")
    with pytest.raises(RuntimeError, match="always"):
        run_with_restarts(broken, 0, 3, lambda: 0, max_restarts=2)


def test_watchdog_flags_persistent_straggler():
    wd = StepWatchdog(deadline_s=1.0, max_misses=2)
    assert not wd.observe(0.5)
    assert not wd.observe(1.5)
    assert wd.observe(1.5)
    assert not wd.observe(0.1) and wd.observed == 4


def _ref_launcher_main(ckpt_dir, mp):
    """The reference's train launcher (tiny, 7 steps, a checkpoint every
    5) on ``ckpt_dir``; returns the batches its stream gave, in order."""
    import sys

    import repro.launch.train as ref_train
    real, drawn = ref_train.make_pipeline, []

    def recording(*args, **kwargs):
        for batch in real(*args, **kwargs):
            drawn.append(batch["tokens"])
            yield batch
    mp.setattr(ref_train, "make_pipeline", recording)
    mp.setattr(sys, "argv", [
        "train", "--tiny", "--steps", "7", "--ckpt-every", "5", "--seq",
        "16", "--global-batch", "4", "--ckpt-dir", str(ckpt_dir)])
    ref_train.main()
    return drawn


@pytest.fixture(scope="module")
def ref_launcher_run(tmp_path_factory):
    ckpt_dir = tmp_path_factory.mktemp("ref_launcher")
    with pytest.MonkeyPatch.context() as mp:
        drawn = _ref_launcher_main(ckpt_dir, mp)
    return ckpt_dir, drawn


def test_reference_launcher_labels_checkpoints_one_step_early(
        ref_launcher_run):
    """A fault of the reference the port does not copy: its launcher saves
    after the update of step index s under the label s
    (``launch/train.py:104-105``), so ``step_5`` holds 6 updates and a
    resume from it repeats one.  The port labels a checkpoint with the
    updates it holds (``test_torch_training.py``)."""
    tmp_path, _ = ref_launcher_run
    for label, updates in ((5, 6), (7, 7)):
        d = tmp_path / f"step_{label:010d}"
        with np.load(d / "arrays.npz") as arrays:
            assert int(arrays["opt/step"]) == updates


def test_reference_launcher_resumes_on_the_first_batches(ref_launcher_run,
                                                         tmp_path,
                                                         monkeypatch):
    """A fault of the reference the port does not copy: a resumed run
    builds its stream anew and skips none of the batches the checkpoint
    consumed (``launch/train.py:78-91``).  ``step_7`` deleted, the run
    again resumes from ``step_5`` and trains step 5 on batch 0, where the
    uninterrupted run trained it on batch 5.  The port advances its
    stream by the restored step (``test_torch_training.py``)."""
    import shutil
    src, first = ref_launcher_run
    shutil.copytree(src, tmp_path / "ck")
    shutil.rmtree(tmp_path / "ck" / "step_0000000007")
    again = _ref_launcher_main(tmp_path / "ck", monkeypatch)
    assert len(first) == 7 and len(again) == 2      # steps 5 and 6
    np.testing.assert_array_equal(again[0], first[0])
    np.testing.assert_array_equal(again[1], first[1])
    assert not np.array_equal(again[0], first[5])
