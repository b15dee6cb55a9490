"""Expert parallelism over ``all_to_all_single`` against the reference.

(a) World 1 (a one-rank gloo group in this process): the port's
    ``ep_moe_ffn`` equals the reference's ``ep_moe_ffn`` on a 1 x 1 mesh
    at (E, k) in {(8, 2), (6, 2)}, swiglu, f32, at capacity factor 8 (no
    drops) and 0.25 (drops), within 1e-5.
(b) World 4 (four gloo processes, one launch for every case): at (8, 2),
    (6, 2) (experts padded to 8) and (16, 4), capacity factor 8, the
    ranks' outputs together equal the reference's ``moe_ffn`` within 1e-4.
(c) At capacity factor 0.25, world 4 equals the world-1 results on each
    quarter of the tokens within 1e-4, with the same drops: the capacity
    is per source rank, so a rank's drops depend only on its own tokens.
(d) A gelu expert set with a shared expert, world 4, against ``moe_ffn``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.core.arch import FFNSpec as RefFFN  # noqa: E402
from repro.dist.ep_moe import ep_moe_ffn as ref_ep_moe_ffn  # noqa: E402
from repro.launch.mesh import make_debug_mesh as ref_debug_mesh  # noqa: E402
from repro.models.moe import init_moe as ref_init_moe  # noqa: E402
from repro.models.moe import moe_ffn as ref_moe_ffn  # noqa: E402
from repro_torch.core.arch import FFNSpec  # noqa: E402
from repro_torch.dist.ep_moe import (capacity, ep_moe_ffn,  # noqa: E402
                                     expert_layout, local_experts)

ROOT = Path(__file__).resolve().parents[1]
D, D_FF, T, WORLD = 64, 32, 32, 4
TOL_W1, TOL_W4 = 1e-5, 1e-4

# name -> (E, k, activation, shared experts, capacity factor)
CASES = {"e8_k2": (8, 2, "swiglu", 0, 8.0),
         "e6_k2": (6, 2, "swiglu", 0, 8.0),
         "e16_k4": (16, 4, "swiglu", 0, 8.0),
         "e8_k2_drops": (8, 2, "swiglu", 0, 0.25),
         "gelu_shared": (8, 2, "gelu", 1, 8.0)}


def _spec(e, k, act, shared, cls=FFNSpec):
    return cls(kind="moe", d_ff=D_FF, activation=act, n_experts=e, top_k=k,
               n_shared_experts=shared)


def _inputs(name):
    """(reference params, x) from seeds; the same arrays for every test."""
    e, k, act, shared, _ = CASES[name]
    params = ref_init_moe(jax.random.PRNGKey(0), D,
                          _spec(e, k, act, shared, RefFFN), dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (T, D), jnp.float32)
    return params, x


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo group for this module, destroyed after it."""
    rdzv = tmp_path_factory.mktemp("ep_w1") / "rdzv"
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _port_w1(name, x_rows, stats=None):
    e, k, act, shared, cf = CASES[name]
    f = _spec(e, k, act, shared)
    params, _ = _inputs(name)
    return ep_moe_ffn(local_experts(_torch(params), f, 0, 1), f,
                      torch.from_numpy(np.array(x_rows)),
                      capacity_factor=cf, stats=stats)


# ---------------------------------------------------------------------------
# (a) world 1 against the reference's ep_moe_ffn
# ---------------------------------------------------------------------------

W1_CASES = [(name, cf) for name in ("e8_k2", "e6_k2") for cf in (8.0, 0.25)]


@pytest.fixture(scope="module")
def ref_world1():
    """The reference's ``ep_moe_ffn`` on a 1 x 1 mesh for every (a) case,
    compiled in parallel threads (each case is a jit compile of seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    def run(case):
        name, cf = case
        e, k, act, shared, _ = CASES[name]
        params, x = _inputs(name)
        return np.asarray(ref_ep_moe_ffn(
            params, _spec(e, k, act, shared, RefFFN), x,
            ref_debug_mesh(1, 1), capacity_factor=cf))
    with ThreadPoolExecutor(len(W1_CASES)) as pool:
        return dict(zip(W1_CASES, pool.map(run, W1_CASES)))


@pytest.mark.parametrize("name,cf", W1_CASES)
def test_world1_equals_the_reference_ep_moe(world1, ref_world1, name, cf):
    e, k, act, shared, _ = CASES[name]
    params, x = _inputs(name)
    want = ref_world1[name, cf]
    f = _spec(e, k, act, shared)
    stats = {}
    got = ep_moe_ffn(local_experts(_torch(params), f, 0, 1), f,
                     torch.from_numpy(np.array(x)), capacity_factor=cf,
                     stats=stats).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_W1)
    assert stats["capacity"] == capacity(cf, T, k, e)
    assert (int(stats["dropped"]) > 0) == (cf < 1)


# ---------------------------------------------------------------------------
# (b)-(d) world 4: four gloo processes, every case in one launch
# ---------------------------------------------------------------------------

WORKER = r"""
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.core.arch import FFNSpec
from repro_torch.dist.ep_moe import ep_moe_ffn, local_experts
rdzv, inputs, out_dir = sys.argv[1:4]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method="file://" + rdzv, rank=rank,
                        world_size=world)
cases = json.loads(open(inputs + ".json").read())
data = np.load(inputs + ".npz")
outs = {}
for name, (e, k, act, shared, cf) in cases.items():
    f = FFNSpec(kind="moe", d_ff=int(data["d_ff"]), activation=act,
                n_experts=e, top_k=k, n_shared_experts=shared)
    params = {key.split("/", 1)[1]: torch.from_numpy(data[key])
              for key in data.files if key.startswith(name + "/")
              and key != name + "/x"}
    x = torch.from_numpy(data[name + "/x"])
    t_loc = x.shape[0] // world
    stats = {}
    out = ep_moe_ffn(local_experts(params, f, rank, world), f,
                     x[rank * t_loc:(rank + 1) * t_loc],
                     capacity_factor=cf, stats=stats)
    outs[name] = out.numpy()
    outs[name + "/dropped"] = stats["dropped"].numpy()
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **outs)
dist.destroy_process_group()
"""


def run_ranks(script: str, args, world: int, tmp: Path, timeout=240):
    """``script`` as ``world`` processes (RANK / WORLD_SIZE set), waited
    for; their output on failure."""
    path = tmp / "worker.py"
    path.write_text(script)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(path), *map(str, args)],
                              env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """{case: (T, d) output of the four ranks in rank order, and
    "<case>/dropped": each rank's drop count}."""
    tmp = tmp_path_factory.mktemp("ep_w4")
    arrays = {"d_ff": np.array(D_FF)}
    for name in CASES:
        params, x = _inputs(name)
        arrays[name + "/x"] = np.asarray(x)
        arrays.update({f"{name}/{k}": np.asarray(v)
                       for k, v in params.items()})
    np.savez(tmp / "inputs.npz", **arrays)
    (tmp / "inputs.json").write_text(json.dumps(CASES))
    run_ranks(WORKER, [tmp / "rdzv", tmp / "inputs", tmp], WORLD, tmp)
    ranks = [np.load(tmp / f"rank{r}.npz") for r in range(WORLD)]
    out = {name: np.concatenate([r[name] for r in ranks]) for name in CASES}
    out.update({f"{name}/dropped": [int(r[name + "/dropped"])
                                    for r in ranks] for name in CASES})
    return out


@pytest.mark.parametrize("name", ("e8_k2", "e6_k2", "e16_k4", "gelu_shared"))
def test_world4_equals_the_reference_moe_ffn(world4, name):
    e, k, act, shared, _ = CASES[name]
    params, x = _inputs(name)
    want, _ = ref_moe_ffn(params, _spec(e, k, act, shared, RefFFN), x)
    np.testing.assert_allclose(world4[name], np.asarray(want), rtol=0,
                               atol=TOL_W4)
    assert world4[name + "/dropped"] == [0] * WORLD


def test_world4_drops_equal_world1_per_quarter(world1, world4):
    name = "e8_k2_drops"
    params, x = _inputs(name)
    t_loc = T // WORLD
    want, dropped = [], []
    for r in range(WORLD):
        stats = {}
        want.append(_port_w1(name, np.asarray(x)[r * t_loc:(r + 1) * t_loc],
                             stats).numpy())
        dropped.append(int(stats["dropped"]))
    # the same pairs are dropped; the products run over buffers of
    # another size (n_ep x capacity rows), so f32 sums in another order
    assert world4[name + "/dropped"] == dropped and sum(dropped) > 0
    np.testing.assert_allclose(world4[name], np.concatenate(want), rtol=0,
                               atol=TOL_W4)
    # and the drops lose weight: the output differs from the dropless one
    full, _ = ref_moe_ffn(params, _spec(8, 2, "swiglu", 0, RefFFN), x)
    assert np.abs(world4[name] - np.asarray(full)).max() > 1e-2


def test_expert_layout_and_capacity():
    assert expert_layout(6, 4) == (8, 2)
    assert expert_layout(40, 1) == (40, 40)
    assert capacity(8.0, 8, 2, 8) == 8          # capped at t_loc
    assert capacity(0.25, 8, 2, 8) == 1
    assert capacity(1e-9, 8, 2, 8) == 1         # at least one slot
    w = torch.arange(6 * 2 * 3, dtype=torch.float32).reshape(6, 2, 3)
    shares = [local_experts({"w_up": w, "router": w}, _spec(6, 2, "gelu", 0),
                            r, 4) for r in range(4)]
    assert [s["w_up"].shape[0] for s in shares] == [2] * 4
    assert torch.equal(torch.cat([s["w_up"] for s in shares])[:6], w)
    assert not shares[3]["w_up"].any()          # both padded experts
    assert all(s["router"] is w for s in shares)
