"""A configuration file (``configs/<name>.json``) and the port's
``ArchConfig`` it is run as.

The file holds the published ``config.json`` keys at their published
values, ``arch`` (the port's architecture id), ``reduced`` (keys cut from
the source) and ``port_departures``: what the port runs differently from
the published model, each ``{"published": ..., "run": ...}``.  The port's
config is checked against the file key by key, so the file is the
configuration as it is run.  ``"preset": "reduced"`` (the tests' files
only) takes the port's small CPU variant of ``arch``.
"""
from __future__ import annotations

from typing import Dict


def run_value(conf: Dict, key: str, default=None):
    """A key's value as the port runs it: its departure's ``run`` where
    the port departs, else the file's (published) value."""
    dep = conf.get("port_departures", {}).get(key)
    if dep is not None:
        return dep["run"]
    return conf.get(key, default)


def shape_spec(conf: Dict) -> Dict:
    """The sizes the plain reference and the counts read."""
    heads = conf["num_attention_heads"]
    return {
        "layers": conf["num_hidden_layers"],
        "d": conf["hidden_size"],
        "vocab": conf["vocab_size"],
        "heads": heads,
        "kv_heads": conf["num_key_value_heads"],
        "head_dim": conf.get("head_dim", conf["hidden_size"] // heads),
        "d_ff": conf["intermediate_size"],
        "experts": conf.get("num_local_experts", 0),
        "top_k": conf.get("num_experts_per_tok", 0),
        "tied": bool(conf.get("tie_word_embeddings", False)),
        "rope_theta": float(run_value(conf, "rope_theta", 10000.0)),
        "norm_eps": float(run_value(conf, "rms_norm_eps", run_value(
            conf, "layer_norm_eps", 1e-5))),
        "rotary_fraction": float(run_value(conf, "partial_rotary_factor",
                                           1.0)),
    }


def arch_config(conf: Dict):
    """The port's ``ArchConfig`` of ``conf``, checked against it."""
    from repro_torch.configs import get_config
    cfg = get_config(conf["arch"], reduced=conf.get("preset") == "reduced")
    s = shape_spec(conf)
    a, f = cfg.attention, cfg.ffn
    pairs = {
        "num_hidden_layers": (s["layers"], cfg.n_layers),
        "hidden_size": (s["d"], cfg.d_model),
        "vocab_size": (s["vocab"], cfg.vocab_size),
        "num_attention_heads": (s["heads"], a.n_heads),
        "num_key_value_heads": (s["kv_heads"], a.n_kv_heads),
        "head_dim": (s["head_dim"], a.head_dim),
        "intermediate_size": (s["d_ff"], f.d_ff),
        "num_local_experts": (s["experts"], f.n_experts),
        "num_experts_per_tok": (s["top_k"], f.top_k),
        "tie_word_embeddings": (s["tied"], cfg.tie_embeddings),
        "rope_theta": (s["rope_theta"], cfg.rope_theta),
        "rms_norm_eps": (s["norm_eps"], cfg.norm_eps),
    }
    bad = {k: v for k, v in pairs.items() if v[0] != v[1]}
    if a.kind != "gqa" or f.activation != "swiglu" or f.n_shared_experts:
        bad["kind"] = (conf["arch"], "a GQA decoder with SwiGLU FFNs")
    if s["rotary_fraction"] != 1.0:
        bad["partial_rotary_factor"] = (s["rotary_fraction"], 1.0)
    if bad:
        raise ValueError(f"{conf['arch']}: the port's config differs from "
                         f"the file (file, port): {bad}")
    return cfg
