"""repro_torch.core — the paper's contribution, Near-Free Parallelism
(NFP), copied from the reference's framework-free modules, with the H100
and the paper's GPUs as hardware presets and device selection.

Public API (the reference's, less its TPU preset):
  hardware:    HardwareSpec, H100, H20/A800/H800, get_hardware
  arch:        ArchConfig, AttentionSpec, FFNSpec, SSMSpec, ShapeSpec
  granularity: GranularitySpec, select_q_block, select_token_block, ...
  nfp:         idle-compute baselines + NFP principle predictors
  simulate:    roofline+granularity latency simulator
  measure:     T(N) sweep + N_max(eps) extraction protocol
"""
from repro_torch.core.arch import (LAYER_ATTN, LAYER_HYBRID, LAYER_SSM,
                                   LM_SHAPES, ArchConfig, AttentionSpec,
                                   EncoderSpec, FFNSpec, ShapeSpec, SSMSpec,
                                   shape_applicable)
from repro_torch.core.granularity import (GranularitySpec, attn_padded_q,
                                          cdiv, m_attn, m_moe,
                                          moe_padded_tokens, moe_tau,
                                          round_up, select_q_block,
                                          select_scan_chunk,
                                          select_token_block)
from repro_torch.core.hardware import (A800, BYTES_BF16, H20, H100, H800,
                                       HardwareSpec, get_hardware)
from repro_torch.core.measure import (LatencyCurve, balanced_moe_baseline_n,
                                      extract_nmax, sensitivity_sweep,
                                      staircase_boundaries, sweep_callable,
                                      time_callable)
from repro_torch.core.nfp import (NFPPrediction, ai_attn, ai_dense, ai_moe,
                                  n_idle_attn, n_idle_attn_general,
                                  n_idle_dense, n_idle_moe, n_idle_ssm,
                                  parallelism_budget, predict_dense,
                                  predict_model, predict_moe_balanced,
                                  predict_moe_skewed)
from repro_torch.core.simulate import (ForwardCost, ModuleCost,
                                       attention_core_cost,
                                       decode_forward_cost, dense_ffn_cost,
                                       latency_curve, module_latency_curve,
                                       moe_ffn_cost, ssm_cost)

__all__ = [n for n in dir() if not n.startswith("_")]
