"""The plain float32 reference against the port's forward, both in f32
on the CPU, at the port's small configurations."""
import pytest
import torch

from bench import model_config, weights
from bench.reference import model
from bench.tests.conftest import TINY


@pytest.mark.parametrize("arch", sorted(TINY))
def test_reference_logits_match_the_port_in_f32(arch):
    from repro_torch.core.tree import tree_map
    from repro_torch.models.transformer import forward
    conf = TINY[arch]
    cfg = model_config.arch_config(conf)
    spec = model_config.shape_spec(conf)
    params = tree_map(lambda t: t.float(),
                      weights.make_params(cfg, conf, 2 ** 31 + 9, "cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (37,),
                           generator=torch.Generator().manual_seed(3))
    want, _, _, _ = forward(params, cfg, {"tokens": tokens[None]},
                            mode="train")
    got = model.logits(params, spec,
                       model.final_hidden(params, spec, tokens))
    scale = want.abs().max()
    assert (got - want[0]).abs().max() <= 1e-5 * scale


def test_weights_follow_the_seed_and_the_layout():
    from repro_torch.core.tree import leaves_with_paths, path_key
    conf = TINY["granite_moe_3b_a800m"]
    cfg = model_config.arch_config(conf)
    a = weights.make_params(cfg, conf, 2 ** 31 + 1, "cpu")
    b = weights.make_params(cfg, conf, 2 ** 31 + 1, "cpu")
    c = weights.make_params(cfg, conf, 2 ** 31 + 2, "cpu")
    shape = weights.layout(cfg)
    pa, pb, pc = (dict(leaves_with_paths(x)) for x in (a, b, c))
    for path, leaf in leaves_with_paths(shape):
        assert pa[path].shape == leaf.shape and pa[path].dtype == leaf.dtype
        assert torch.equal(pa[path], pb[path])
        if path[-1] == "scale":
            assert torch.all(pa[path] == 1)
        else:
            assert not torch.equal(pa[path], pc[path]), path_key(path)
            std = pa[path].float().std().item()
            assert 0.015 < std < 0.025, path_key(path)
    assert pa[("segments", 0, "ffn", "router")].dtype == torch.float32


def test_fp8_products_are_coarser_than_bf16():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 256, generator=g)
    w = torch.randn(256, 128, generator=g) * 0.02
    exact = x @ w
    err8 = (model.fp8_mm(x, w) - exact).abs().max()
    err16 = (x.bfloat16().float() @ w.bfloat16().float() - exact).abs().max()
    assert err8 > 4 * err16
    assert err8 < 0.1 * exact.abs().max()
