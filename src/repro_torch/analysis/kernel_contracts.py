"""Checker 3: the CUDA kernels' launch contracts (the counterpart of the
reference's ``analysis/pallas_contracts.py``, which hooks
``pl.pallas_call``; the port's launch boundary is the ctypes call into a
``csrc/*.cu`` entry point).

Each kernel wrapper passes its entry point the tensors' pointers and a
block of scalars that a pure function of the shapes computes
(``dense_launch_args`` / ``paged_launch_args`` in
``kernels/decode_attention/ops.py``, ``launch_args`` in ``moe_ffn/ops.py``
and ``mamba_scan/ops.py``).  So the launches are checkable on any host:

  KC001  the ctypes ``argtypes`` of an entry point (``_SIGNATURES`` /
         ``_SIGNATURE``) differ, in count or in kind (pointer / int /
         float), from the ``extern "C"`` parameter list parsed from its
         ``.cu`` file — silent undefined behaviour under ctypes — or a
         launch passes arguments the signature does not take
  KC002  a launched tile does not divide what it must or lies outside
         the kernel's limits (its ``constexpr``s): the q tile a multiple
         of 16, the kv tile within ``kMaxKBlock``, the span of kv tiles
         within the table and ``kMaxSpan``, ``dh`` within
         ``kMaxDh``, the MoE token block a multiple of 16 dividing the
         padded rows, the scan's positions a whole number of
         ``kSteps`` chunks and ``ds`` within ``kMaxState``
  KC003  a RECORDED launch's scalars are not what the launch-args
         function gives at the recorded shapes, or not the served
         model's geometry

``config_launches`` evaluates the launch-args functions at the decode and
prefill shapes of the twelve configs (the counterpart of the reference's
capture targets).  On the card, ``LaunchRecorder`` wraps the loaded
libraries (``kernels/build.py``'s ``_loaded``) and records every call's
integer arguments, pointers blanked: it reads no tensor, so it is safe
under a CUDA-graph capture.  A replay calls no wrapper, so records come
from captures and eager forwards.
"""
from __future__ import annotations

import ctypes
import re
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding

CHECKER = "kernel-contract"

#: entry point -> (its .cu file, its ops module)
ENTRY_POINTS = {
    "decode_attention_dense": ("decode_attention", "decode_attention"),
    "decode_attention_paged": ("decode_attention", "decode_attention"),
    "moe_ffn": ("moe_ffn", "moe_ffn"),
    "mamba_scan": ("mamba_scan", "mamba_scan"),
}
ATTENTION = ("decode_attention_dense", "decode_attention_paged")
PTR = "ptr"                     # a non-null pointer in a recorded launch

# decode widths and the serving batch / cache of ``config_launches``
DECODE_WIDTHS = (1, 16, 17)
BATCH = 4
MAX_LEN = 256
PAGE = 16
PREFILL_LENS = (48, 64)

_EXTERN_RE = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(([^)]*)\)',
                        re.S)
_CONSTEXPR_RE = re.compile(
    r"^\s*constexpr\s+(?:int|size_t|unsigned)\s+(\w+)\s*=\s*(\d+)\s*;", re.M)


# ---------------------------------------------------------------------------
# the sources: extern "C" parameter lists and constexprs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExternSignature:
    name: str
    line: int
    kinds: Tuple[str, ...]          # "pointer" | "int" | "float" per param
    params: Tuple[str, ...]         # parameter names


def _param_kind(decl: str) -> str:
    decl = " ".join(decl.split())
    if "*" in decl or decl.startswith(("cudaStream_t", "const cudaStream_t")):
        return "pointer"
    if re.match(r"(const\s+)?(float|double)\b", decl):
        return "float"
    return "int"


def extern_signatures(text: str) -> Dict[str, ExternSignature]:
    """Every ``extern "C"`` function of a ``.cu`` source: its parameter
    kinds and names, and the line it starts on."""
    out = {}
    for m in _EXTERN_RE.finditer(text):
        decls = [d.strip() for d in m.group(2).split(",") if d.strip()]
        names = tuple(re.split(r"[\s\*]+", d)[-1] for d in decls)
        out[m.group(1)] = ExternSignature(
            m.group(1), text.count("\n", 0, m.start()) + 1,
            tuple(_param_kind(d) for d in decls), names)
    return out


def constexprs(text: str) -> Dict[str, int]:
    """The integer ``constexpr``s declared at the start of a line."""
    return {m.group(1): int(m.group(2))
            for m in _CONSTEXPR_RE.finditer(text)}


def ctypes_kind(argtype) -> str:
    if argtype in (ctypes.c_float, ctypes.c_double):
        return "float"
    if argtype in (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_wchar_p) or (
            isinstance(argtype, type)
            and issubclass(argtype, (ctypes._Pointer, ctypes.c_void_p))):
        return "pointer"
    return "int"


def _ops(entry: str):
    """The ops module of an entry point (imported on use: it imports
    torch)."""
    import importlib
    return importlib.import_module(
        f"repro_torch.kernels.{ENTRY_POINTS[entry][1]}.ops")


def declared_signatures() -> Dict[str, List]:
    """{entry point: the ctypes argtypes its wrapper declares}."""
    out = {}
    for entry in ENTRY_POINTS:
        ops = _ops(entry)
        sigs = getattr(ops, "_SIGNATURES", None)
        out[entry] = (sigs[entry] if sigs is not None
                      else getattr(ops, "_SIGNATURE"))
    return out


def read_sources() -> Dict[str, str]:
    """{source name: text} of the ``.cu`` files the entry points live in."""
    from repro_torch.kernels.build import CSRC
    return {name: (CSRC / f"{name}.cu").read_text()
            for name in sorted({cu for cu, _ in ENTRY_POINTS.values()})}


def kernel_limits(sources: Dict[str, str]) -> Dict[str, int]:
    """Every source's constexprs, in one namespace per source:
    ``{"decode_attention.kMaxDh": 128, ...}``."""
    return {f"{name}.{k}": v for name, text in sources.items()
            for k, v in constexprs(text).items()}


# ---------------------------------------------------------------------------
# KC001: ctypes signatures against the extern "C" parameter lists
# ---------------------------------------------------------------------------

def check_signatures(sources: Optional[Dict[str, str]] = None,
                     signatures: Optional[Dict[str, List]] = None
                     ) -> List[Finding]:
    sources = read_sources() if sources is None else sources
    signatures = declared_signatures() if signatures is None else signatures
    out: List[Finding] = []
    for entry, argtypes in sorted(signatures.items()):
        cu = ENTRY_POINTS[entry][0]
        path = f"src/repro_torch/kernels/{ENTRY_POINTS[entry][1]}/ops.py"
        ext = extern_signatures(sources.get(cu, "")).get(entry)
        if ext is None:
            out.append(Finding(CHECKER, "KC001", path, 1, entry,
                               f'no extern "C" {entry} in csrc/{cu}.cu'))
            continue
        kinds = tuple(ctypes_kind(a) for a in argtypes)
        if kinds != ext.kinds:
            out.append(Finding(
                CHECKER, "KC001", path, 1, entry,
                f"ctypes argtypes ({len(kinds)}: {', '.join(kinds)}) != "
                f'extern "C" parameters of csrc/{cu}.cu:{ext.line} '
                f"({len(ext.kinds)}: {', '.join(ext.kinds)}): ctypes would "
                "pass the arguments into the wrong registers",
                snippet=f"{entry}({', '.join(ext.params)})"))
    return out


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

@dataclass
class LaunchRecord:
    """One launch (or ``count`` identical ones) of an entry point: its
    arguments in order, pointers as ``PTR`` (null as None)."""
    entry: str
    args: Tuple
    label: str = ""
    count: int = 1
    tokens: Optional[int] = None     # MoE: the token count T, when known
    experts: Optional[int] = None    # MoE: E, when known

    def scalars(self, ext: ExternSignature) -> Dict[str, object]:
        """The non-pointer arguments by their parameter names."""
        return {name: a for name, kind, a in zip(ext.params, ext.kinds,
                                                 self.args)
                if kind != "pointer"}


def synthetic(entry: str, scalars: Sequence, ext: ExternSignature,
              label: str, **kw) -> LaunchRecord:
    """A launch record from a scalar block: pointers ``PTR`` around it,
    as the wrapper passes them."""
    it = iter(scalars)
    args = tuple(PTR if kind == "pointer" else next(it)
                 for kind in ext.kinds)
    return LaunchRecord(entry, args, label, **kw)


def check_launch(record: LaunchRecord, ext: Optional[ExternSignature],
                 limits: Dict[str, int]) -> List[Finding]:
    """KC001 (arity and kinds of the passed arguments) and KC002 (tiles
    against the kernel's limits) for one launch."""
    cu = ENTRY_POINTS[record.entry][0]
    path = f"src/repro_torch/csrc/{cu}.cu"
    symbol = f"{record.entry}[{record.label}]"
    out: List[Finding] = []

    def emit(rule: str, message: str) -> None:
        out.append(Finding(CHECKER, rule, path, ext.line if ext else 1,
                           symbol, message, snippet=repr(record.args)))

    if ext is None:
        emit("KC001", f'no extern "C" {record.entry} in csrc/{cu}.cu')
        return out
    if len(record.args) != len(ext.kinds):
        emit("KC001", f"the launch passes {len(record.args)} arguments; "
                      f"the entry point takes {len(ext.kinds)}")
        return out
    for i, (kind, a) in enumerate(zip(ext.kinds, record.args)):
        ok = (a is None or a == PTR if kind == "pointer"
              else isinstance(a, int) and not isinstance(a, bool)
              if kind == "int" else isinstance(a, (int, float)))
        if not ok:
            emit("KC001", f"argument {i} ({ext.params[i]}) is {a!r}; the "
                          f"entry point takes a {kind}")
            return out
    v = record.scalars(ext)

    def limit(name: str) -> int:
        key = f"{cu}.{name}"
        if key not in limits:
            emit("KC002", f"constexpr {name} not found in csrc/{cu}.cu")
            return 0
        return limits[key]

    def need(cond: bool, message: str) -> None:
        if not cond:
            emit("KC002", message)

    if record.entry in ATTENTION:
        kb = v["k_block"] if "k_block" in v else v["block_size"]
        tiles = (v["max_blocks"] if "max_blocks" in v
                 else -(-v["s_max"] // max(kb, 1)))
        max_kb, max_dh = limit("kMaxKBlock"), limit("kMaxDh")
        max_span = limit("kMaxSpan")
        need(v["q_block"] >= 16 and v["q_block"] % 16 == 0,
             f"q tile {v['q_block']} is not a multiple of the 16-row MMA "
             "tile")
        need(1 <= kb <= max_kb, f"kv tile {kb} outside [1, kMaxKBlock = "
                                f"{max_kb}]")
        if 1 <= kb <= max_kb:
            need(1 <= v["span"] <= min(max(tiles, 1), max_span),
                 f"span of {v['span']} kv tiles outside [1, min({tiles} "
                 f"tiles, kMaxSpan = {max_span})]")
        need(v["dh"] % 16 == 0 and 16 <= v["dh"] <= max_dh,
             f"head_dim {v['dh']}: the kernel takes multiples of 16 up to "
             f"kMaxDh = {max_dh}")
        need(v["kv"] >= 1 and v["h"] % v["kv"] == 0,
             f"{v['h']} query heads do not group over {v['kv']} kv heads")
        need(v["n"] >= 1 and v["b"] >= 1, "an empty launch")
        need(v["window"] == -1 or v["window"] >= 1,
             f"window {v['window']} is neither -1 (none) nor >= 1")
    elif record.entry == "moe_ffn":
        tb, f = v["token_block"], v["f"]
        need(tb >= 16 and tb % 16 == 0,
             f"token block {tb} is not a multiple of the 16-row sub-block")
        need(tb > 0 and v["m_pad"] % tb == 0,
             f"token block {tb} does not divide the {v['m_pad']} padded "
             "rows (a partial block)")
        need(v["d"] % 8 == 0 and f % 8 == 0,
             f"d {v['d']} and f {f} must be multiples of 8")
        need(f <= 512 or f % 512 == 0,
             f"f {f} > 512 is not a whole number of 512-column tiles")
        need(v["gated"] in (0, 1), f"gated {v['gated']} is not 0 or 1")
    elif record.entry == "mamba_scan":
        steps, max_state = limit("kSteps"), limit("kMaxState")
        need(steps > 0 and v["s_pad"] % steps == 0,
             f"{v['s_pad']} positions are not a whole number of "
             f"kSteps = {steps} chunks")
        need(1 <= v["ds"] <= max_state,
             f"d_state {v['ds']} outside [1, kMaxState = {max_state}]")
    return out


def check_launches(records: Sequence[LaunchRecord],
                   sources: Optional[Dict[str, str]] = None
                   ) -> List[Finding]:
    sources = read_sources() if sources is None else sources
    limits = kernel_limits(sources)
    exts = {e: extern_signatures(sources.get(cu, "")).get(e)
            for e, (cu, _) in ENTRY_POINTS.items()}
    out: List[Finding] = []
    for r in records:
        out.extend(check_launch(r, exts[r.entry], limits))
    return out


# ---------------------------------------------------------------------------
# the launch-args functions at the twelve configs' shapes
# ---------------------------------------------------------------------------

def _attn_window(cfg) -> Optional[int]:
    a = cfg.attention
    return a.window if a.kind == "swa" else None


def attention_kernel(cfg) -> bool:
    """GQA and sliding-window GQA run the decode-attention kernel; MLA
    and attention-free models do not."""
    return cfg.attention is not None and cfg.attention.kind != "mla"


def moe_scalars(cfg, tokens: int) -> Tuple:
    """The ``moe_ffn`` scalars of a forward over ``tokens`` tokens:
    ``grouped_ffn``'s token block and padded rows, then the wrapper's."""
    from repro_torch.core.granularity import select_token_block
    from repro_torch.kernels.moe_ffn import ops
    f = cfg.ffn
    tb = select_token_block(tokens, f.n_experts)
    m_pad = ops.padded_rows(tokens * f.top_k, f.n_experts, tb)
    return ops.launch_args((m_pad, cfg.d_model), (f.n_experts, cfg.d_model,
                                                  f.d_ff), tb,
                           f.activation == "swiglu")


def config_launches(arch_ids: Optional[Sequence[str]] = None,
                    sources: Optional[Dict[str, str]] = None
                    ) -> List[LaunchRecord]:
    """The launches each config's decode (widths ``DECODE_WIDTHS`` over
    ``BATCH`` slots of ``MAX_LEN``, dense and ``PAGE``-position pages)
    and prefill (``PREFILL_LENS``) would make, from the launch-args
    functions."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels.decode_attention import ops as attn
    from repro_torch.kernels.mamba_scan import ops as scan
    sources = read_sources() if sources is None else sources
    exts = {e: extern_signatures(sources[cu])[e]
            for e, (cu, _) in ENTRY_POINTS.items()}
    out: List[LaunchRecord] = []
    for arch in arch_ids or ARCH_IDS:
        cfg = get_config(arch)
        if attention_kernel(cfg):
            a = cfg.attention
            win = _attn_window(cfg)
            for n in DECODE_WIDTHS:
                q = (BATCH, n, a.n_heads, a.head_dim)
                out.append(synthetic(
                    "decode_attention_dense", attn.dense_launch_args(
                        q, (BATCH, MAX_LEN, a.n_kv_heads, a.head_dim), win),
                    exts["decode_attention_dense"], f"{arch}/dense/n{n}"))
                out.append(synthetic(
                    "decode_attention_paged", attn.paged_launch_args(
                        q, (BATCH * MAX_LEN // PAGE + 1, PAGE, a.n_kv_heads,
                            a.head_dim), (BATCH, MAX_LEN // PAGE), win),
                    exts["decode_attention_paged"], f"{arch}/paged/n{n}"))
        if cfg.ffn.kind == "moe":
            for tokens, regime in [(BATCH * n, f"decode/n{n}")
                                   for n in DECODE_WIDTHS] + [
                    (s, f"prefill/s{s}") for s in PREFILL_LENS]:
                out.append(synthetic(
                    "moe_ffn", moe_scalars(cfg, tokens), exts["moe_ffn"],
                    f"{arch}/{regime}", tokens=tokens,
                    experts=cfg.ffn.n_experts))
        if cfg.ssm is not None and cfg.ssm.kind == "mamba1":
            di, ds = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.d_state
            for b, s, regime in [(BATCH, 1, "decode")] + [
                    (1, s, f"prefill/s{s}") for s in PREFILL_LENS]:
                out.append(synthetic(
                    "mamba_scan", scan.launch_args(
                        (b, scan.padded_len(s), di), (di, ds)),
                    exts["mamba_scan"], f"{arch}/{regime}"))
    return out


# ---------------------------------------------------------------------------
# KC003: recorded launches against the launch-args functions
# ---------------------------------------------------------------------------

def moe_tokens(cfg, scalars: Tuple) -> List[int]:
    """The token counts T whose ``moe_ffn`` launch has these scalars."""
    f = cfg.ffn
    m_pad, tb = scalars[0], scalars[3]
    base = f.n_experts * (tb - 1)
    lo = max(1, -(-(m_pad - tb - base + 1) // f.top_k))
    hi = (m_pad - base) // f.top_k
    return [t for t in range(lo, hi + 1) if moe_scalars(cfg, t) == scalars]


def expected_scalars(record: LaunchRecord, ext: ExternSignature, cfg=None
                     ) -> Tuple[Optional[Tuple], str]:
    """(the launch-args function's scalars at the record's shapes, or
    None, and why they differ from the model's geometry)."""
    from repro_torch.kernels.decode_attention import ops as attn
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.kernels.moe_ffn import ops as moe
    v = record.scalars(ext)
    got = tuple(v.values())
    why = ""
    if record.entry in ATTENTION:
        b, n, h, kv, dh = (v[k] for k in ("b", "n", "h", "kv", "dh"))
        win = None if v["window"] == -1 else v["window"]
        if record.entry == "decode_attention_dense":
            want = attn.dense_launch_args((b, n, h, dh),
                                          (b, v["s_max"], kv, dh), win)
        else:
            want = attn.paged_launch_args(
                (b, n, h, dh), (0, v["block_size"], kv, dh),
                (b, v["max_blocks"]), win)
        if cfg is not None and not attention_kernel(cfg):
            why = f"{cfg.name} runs no decode-attention kernel"
        elif cfg is not None:
            a = cfg.attention
            geom = (a.n_heads, a.n_kv_heads, a.head_dim, _attn_window(cfg))
            if (h, kv, dh, win) != geom:
                why = f"(h, kv, dh, window) {(h, kv, dh, win)} != {geom}"
    elif record.entry == "moe_ffn":
        want = moe.launch_args((v["m_pad"], v["d"]), (0, v["d"], v["f"]),
                               v["token_block"], bool(v["gated"]))
        if cfg is not None and cfg.ffn.kind != "moe":
            why = f"{cfg.name} has no MoE layer"
        elif cfg is not None:
            tokens = moe_tokens(cfg, got)
            if not tokens:
                why = (f"no token count gives token block "
                       f"{v['token_block']} and {v['m_pad']} padded rows at "
                       f"E {cfg.ffn.n_experts}, top-{cfg.ffn.top_k}")
            else:
                record.tokens = tokens[0]
                record.experts = cfg.ffn.n_experts
    else:
        want = scan.launch_args((v["bsz"], scan.padded_len(v["s_pad"]),
                                 v["di"]), (v["di"], v["ds"]))
        if cfg is not None and (cfg.ssm is None
                                or cfg.ssm.kind != "mamba1"):
            why = f"{cfg.name} has no Mamba1 layer"
        elif cfg is not None:
            geom = (cfg.ssm.d_inner(cfg.d_model), cfg.ssm.d_state)
            if (v["di"], v["ds"]) != geom:
                why = f"(di, ds) {(v['di'], v['ds'])} != {geom}"
    return want, why


def check_recorded(records: Sequence[LaunchRecord],
                   configs: Optional[Dict[str, object]] = None,
                   sources: Optional[Dict[str, str]] = None
                   ) -> List[Finding]:
    """KC001 / KC002 for every recorded launch, and KC003: its scalars
    are the launch-args function's at the recorded shapes, and the
    geometry is that of ``configs[record.label]`` (when given).  MoE
    records get their token count and E filled in."""
    sources = read_sources() if sources is None else sources
    out = check_launches(records, sources)
    exts = {e: extern_signatures(sources[cu])[e]
            for e, (cu, _) in ENTRY_POINTS.items()}
    for r in records:
        ext = exts[r.entry]
        if len(r.args) != len(ext.kinds):
            continue
        cfg = (configs or {}).get(r.label)
        want, why = expected_scalars(r, ext, cfg)
        got = tuple(r.scalars(ext).values())
        msg = why if want == got else (f"scalars {got} != the launch-args "
                                       f"function's {want}")
        if msg:
            out.append(Finding(
                CHECKER, "KC003", f"src/repro_torch/csrc/"
                f"{ENTRY_POINTS[r.entry][0]}.cu", ext.line,
                f"{r.entry}[{r.label}]", msg, snippet=repr(r.args)))
    return out


def distinct_configurations(records: Sequence[LaunchRecord]
                            ) -> Dict[str, int]:
    """{entry point: distinct argument blocks launched}."""
    seen = Counter(r.entry for r in {(r.entry, r.args): r
                                     for r in records}.values())
    return {e: seen.get(e, 0) for e in ENTRY_POINTS}


# ---------------------------------------------------------------------------
# the recorder (on the card)
# ---------------------------------------------------------------------------

class _RecordingEntry:
    """A loaded entry point that records each call, then makes it."""

    def __init__(self, fn, name: str, recorder: "LaunchRecorder"):
        self.__dict__.update(fn=fn, name=name, recorder=recorder,
                             pointers=())

    def __getattr__(self, attr):
        return getattr(self.fn, attr)

    def __setattr__(self, attr, value):          # argtypes / restype
        setattr(self.fn, attr, value)
        if attr == "argtypes":
            self.__dict__["pointers"] = tuple(
                ctypes_kind(a) == "pointer" for a in value or ())

    def __call__(self, *args):
        ptrs = self.pointers
        key = tuple((PTR if a is not None else None)
                    if i < len(ptrs) and ptrs[i] else a
                    for i, a in enumerate(args))
        self.recorder.counts[(self.recorder.label, self.name, key)] += 1
        return self.fn(*args)


class _RecordingLibrary:
    def __init__(self, lib, recorder: "LaunchRecorder"):
        self._lib, self._recorder, self._entries = lib, recorder, {}

    def __getattr__(self, name):
        entry = self._entries.get(name)
        if entry is None:
            entry = self._entries[name] = _RecordingEntry(
                getattr(self._lib, name), name, self._recorder)
        return entry


class LaunchRecorder:
    """Records every launch of the port's kernels while installed (a
    context manager): wraps each library in ``kernels.build._loaded``
    (loading, and so building, those not loaded yet).  ``label`` tags
    the records made until it changes.  Records integer arguments only:
    pointers become ``PTR``, no tensor is read."""

    LIBRARIES = ("decode_attention", "moe_ffn", "mamba_scan")

    def __init__(self, label: str = ""):
        self.label = label
        self.counts: Counter = Counter()
        self._saved: Dict[str, object] = {}

    def __enter__(self) -> "LaunchRecorder":
        from repro_torch.kernels import build
        for name in self.LIBRARIES:
            lib = build.load_library(name)
            self._saved[name] = lib
            build._loaded[name] = _RecordingLibrary(lib, self)
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels import build
        build._loaded.update(self._saved)
        self._saved.clear()

    def records(self) -> List[LaunchRecord]:
        return [LaunchRecord(entry, args, label, count)
                for (label, entry, args), count in self.counts.items()]


def check(records: Optional[Sequence[LaunchRecord]] = None
          ) -> List[Finding]:
    """KC001 on the signatures and KC001 / KC002 on ``records`` (by
    default the twelve configs' launches)."""
    sources = read_sources()
    if records is None:
        records = config_launches(sources=sources)
    return check_signatures(sources) + check_launches(records, sources)
