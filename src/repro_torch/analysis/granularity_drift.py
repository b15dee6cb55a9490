"""Checker 4: granularity drift — tiles declared vs launched vs pinned
(the counterpart of the reference's ``analysis/granularity_drift.py``).

The NFP predictor reads its tile sizes from the port's
``core.granularity``; the CUDA wrappers' launch-args functions read the
SAME selectors.  A careless edit to a selector silently moves both, so
the port's baseline pins a third copy, the ``granularity_contract``,
which must equal the reference's (``k_block`` 128, ``m_attn_decode`` 64,
``m_moe_decode`` 16, ``m_ssm`` 16).

  GD001  declared (what ``core.granularity`` computes today)
         != contract (what the port's baseline pins)
  GD002  launched (the tile a launch passes the kernel, from the
         launch-args functions at the configs' shapes or recorded on the
         card) != declared
  GD003  knob missing from the contract (a tile never pinned)
  GD004  a constant of the plain-PyTorch emulation of a kernel (which the
         CPU tests hold against the Pallas kernels) != the kernel's
         ``constexpr`` parsed from its ``.cu`` (``KV_CHUNK`` / ``kChunk``,
         ``TILE_ROWS`` / ``kTileRows``, ``SSM_CHUNK`` / ``kSteps``,
         ``MAX_STATE`` / ``kMaxState``): the emulation would no longer
         describe the kernel

Drift findings are NEVER baseline-suppressible: the only way to clear
them is to update the pinned contract (``--write-baseline``), which shows
up in review as an explicit granularity change.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.analysis import kernel_contracts as kc
from repro_torch.analysis.findings import Finding

CHECKER = "granularity-drift"

GRANULARITY_PATH = "src/repro_torch/core/granularity.py"


def declared_tiles() -> Dict[str, int]:
    """Tile sizes ``core.granularity`` (and the attention ops constant)
    declare for the decode regime — the values the NFP predictor consumes
    through ``GranularitySpec.for_backend``."""
    from repro_torch.core.granularity import (SSM_CHUNK, GranularitySpec,
                                              select_q_block,
                                              select_scan_chunk,
                                              select_token_block)
    from repro_torch.kernels.decode_attention.ops import K_BLOCK

    spec = GranularitySpec.for_backend(n_experts=8, head_dim=128)
    declared = {
        "m_attn_decode": int(select_q_block(1, 128)),
        "m_moe_decode": int(select_token_block(1, 8)),
        "m_ssm": int(SSM_CHUNK),
        "k_block": int(K_BLOCK),
    }
    # the predictor consumes the SAME numbers through GranularitySpec, and
    # the scan pads by select_scan_chunk: a divergence is drift too
    if spec.m_attn != declared["m_attn_decode"]:
        declared["m_attn_decode"] = -abs(spec.m_attn)    # force mismatch
    if spec.m_moe != declared["m_moe_decode"]:
        declared["m_moe_decode"] = -abs(spec.m_moe)
    if spec.m_ssm != declared["m_ssm"] or select_scan_chunk(1) != SSM_CHUNK:
        declared["m_ssm"] = -abs(spec.m_ssm)
    return declared


def launched_tiles(records: Sequence[kc.LaunchRecord],
                   sources: Optional[Dict[str, str]] = None
                   ) -> Dict[str, Set[int]]:
    """The tiles the launches passed: the q tile of every one-position
    decode-attention launch, the dense kv tile, the MoE token block of
    every launch in the decode regime (T <= E, where T is known), and the
    scan chunk (the gcd of the padded lengths)."""
    sources = kc.read_sources() if sources is None else sources
    exts = {e: kc.extern_signatures(sources[cu])[e]
            for e, (cu, _) in kc.ENTRY_POINTS.items()}
    out: Dict[str, Set[int]] = {}
    s_pads: List[int] = []
    for r in records:
        ext = exts[r.entry]
        if len(r.args) != len(ext.kinds):
            continue
        v = r.scalars(ext)
        if r.entry in kc.ATTENTION:
            if v["n"] == 1:
                out.setdefault("m_attn_decode", set()).add(v["q_block"])
            if "k_block" in v:
                out.setdefault("k_block", set()).add(v["k_block"])
        elif r.entry == "moe_ffn":
            if (r.tokens is not None and r.experts is not None
                    and r.tokens <= r.experts):
                out.setdefault("m_moe_decode", set()).add(v["token_block"])
        elif r.entry == "mamba_scan":
            s_pads.append(v["s_pad"])
    if s_pads:
        out["m_ssm"] = {math.gcd(*s_pads)}
    return out


def emulation_pairs(sources: Optional[Dict[str, str]] = None
                    ) -> Dict[str, tuple]:
    """{name: (the emulation's constant, the kernel's constexpr or None)}."""
    from repro_torch.core.granularity import SSM_CHUNK
    from repro_torch.kernels.decode_attention import ops as attn
    from repro_torch.kernels.mamba_scan import ops as scan
    sources = kc.read_sources() if sources is None else sources
    limits = kc.kernel_limits(sources)
    return {
        "KV_CHUNK/kChunk": (attn.KV_CHUNK,
                            limits.get("decode_attention.kChunk")),
        "TILE_ROWS/kTileRows": (attn.TILE_ROWS,
                                limits.get("decode_attention.kTileRows")),
        "SSM_CHUNK/kSteps": (SSM_CHUNK, limits.get("mamba_scan.kSteps")),
        "MAX_STATE/kMaxState": (scan.MAX_STATE,
                                limits.get("mamba_scan.kMaxState")),
    }


def check_drift(contract: Optional[Dict[str, int]],
                declared: Optional[Dict[str, int]] = None,
                launched: Optional[Dict[str, Set[int]]] = None,
                emulation: Optional[Dict[str, tuple]] = None,
                records: Optional[Sequence[kc.LaunchRecord]] = None
                ) -> List[Finding]:
    if declared is None:
        declared = declared_tiles()
    if launched is None:
        if records is None:
            records = kc.config_launches()
        launched = launched_tiles(records)
    if emulation is None:
        emulation = emulation_pairs()
    contract = contract or {}
    out: List[Finding] = []

    def emit(rule: str, knob: str, message: str) -> None:
        out.append(Finding(CHECKER, rule, GRANULARITY_PATH, 1, knob,
                           message))

    for knob in sorted(declared):
        dec = declared[knob]
        if knob not in contract:
            emit("GD003", knob,
                 f"tile knob {knob!r} (= {dec}) is not pinned in the "
                 "baseline's granularity_contract; regenerate with "
                 "--write-baseline to pin it")
        elif contract[knob] != dec:
            emit("GD001", knob,
                 f"core.granularity declares {knob}={dec} but the pinned "
                 f"contract says {contract[knob]}: the NFP predictor's "
                 "inputs changed — if intentional, update the contract via "
                 "--write-baseline (and recalibrate)")
        off = sorted(t for t in launched.get(knob, ()) if t != dec)
        if off:
            emit("GD002", knob,
                 f"kernels launch with {knob}={off} but core.granularity "
                 f"declares {dec}: the launched tiles have drifted off the "
                 "registry the NFP predictor reads")
    for name, (emu, kernel) in sorted(emulation.items()):
        if emu != kernel:
            emit("GD004", name,
                 f"the emulation's {name.split('/')[0]} = {emu} but the "
                 f"kernel's {name.split('/')[1]} = {kernel}: the plain "
                 "emulation the CPU tests hold against Pallas no longer "
                 "describes the kernel")
    return out


def check(records: Optional[Sequence[kc.LaunchRecord]] = None,
          contract: Optional[Dict[str, int]] = None) -> List[Finding]:
    return check_drift(contract, records=records)
