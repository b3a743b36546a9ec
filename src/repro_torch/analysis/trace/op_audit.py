"""Op auditor: host transfers, dtype narrowing and duplicate-index writes
over what a hot path executes.

The port's counterpart of the reference's ``jaxprs.py`` and
``jaxpr_audit.py``.  The port has no jaxpr to walk: its hot paths run
eagerly, so the audit records what a path executes.  :class:`OpRecorder`
is a ``torch.overrides.TorchFunctionMode``; every torch call the path
makes (functions, tensor methods, in-place methods, indexing) passes
through it once, outermost calls only, and it flags three things:

* **host transfers** (``trace-host-callback``): ``.item()``,
  ``.tolist()``, ``.numpy()`` / ``__array__``, ``.cpu()``, a ``.to`` or a
  ``copy_`` onto the CPU, and the truth or number value of a tensor
  (``__bool__``, ``__int__``, ``__float__``, ``__index__``) — each a
  device-to-host read per dispatch, the overhead the launch cache exists
  to remove;
* **silent dtype narrowing on accumulation edges**
  (``trace-dtype-narrowing``): a conversion that loses float precision
  (``.to``/``.type``/``.float``/``.half``/``copy_`` into a narrower
  tensor, or any call given a narrower ``dtype=``) whose result flows, by
  tensor identity, into an accumulation (``index_add_``,
  ``scatter_add_``, ``sum``, ``cumsum``, ``matmul``/``@``, an
  accumulating ``index_put_``).  The taint is the reference's
  conservative one: any call consuming a tainted tensor taints every
  tensor it returns or writes in place, so re-widening before the
  accumulator does not clear it;
* **duplicate-index writes** (``trace-write-conflict``): a
  non-accumulating indexed write (``index_put_(accumulate=False)``,
  ``x[idx] = v``, ``scatter_`` without a reduce, ``index_copy_``,
  ``put_``) whose indices hold duplicates — the last writer wins, in an
  order the card does not fix.

Every indexed write, accumulating or not, is also kept as a write fact
(``OpRecorder.writes``) for ``conflicts.check_write_structure``.

The CUDA kernels are called through ``ctypes`` with raw pointers, so the
recorder sees only the torch calls around them (allocation, views,
``data_ptr``), never what a kernel does inside.  On the card a hot path
also runs under ``torch.cuda.set_sync_debug_mode("error")``
(``audit_hot_path``), which makes the card itself refuse any implicit
synchronisation the recorder cannot name (``torch.linalg.pinv``'s check
of cuSOLVER's status, say).  A refused call is a host-callback finding
at its call site, the first frame outside torch and this module; the
recorder then completes the call with the check off, so the path runs
to its end and every other refusal is found too.  A call site that must
synchronise says so as the AST tier's do, with
``# repro-lint: disable=trace-host-callback`` and a reason on its line
or on its function's ``def`` line.  The recorder's own duplicate check
(a ``torch.unique``) runs with the debug mode off.  On the card an
explicit ``torch.cuda.synchronize()`` and an event's ``synchronize()``
pass the debug mode; a stream's ``synchronize()`` is refused.
"""
from __future__ import annotations

import contextlib
import linecache
import os
import sys
import traceback

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis.linter import _DISABLE_RE, Finding

PASS_CALLBACK = "trace-host-callback"
PASS_NARROWING = "trace-dtype-narrowing"
PASS_CONFLICT = "trace-write-conflict"

#: calls that read a device value on the host
HOST_READS = frozenset({"item", "tolist", "numpy", "__array__", "cpu",
                        "__bool__", "__int__", "__float__", "__index__"})

#: calls that convert dtype (their narrowing is judged input vs output)
CONVERSIONS = frozenset({"to", "type", "float", "half", "bfloat16",
                         "double", "int", "long", "short", "char", "byte",
                         "bool", "copy_"})

#: calls that accumulate values — the sinks narrowing must not reach
ACCUMULATIONS = frozenset({
    "index_add_", "index_add", "scatter_add_", "scatter_add", "sum",
    "nansum", "cumsum", "matmul", "__matmul__", "__rmatmul__", "mm", "bmm",
    "addmm", "einsum", "dot", "mv",
})

#: indexed writes: name -> whether they accumulate (None: by argument)
INDEXED_WRITES = {
    "index_add_": True, "index_add": True, "scatter_add_": True,
    "scatter_add": True, "scatter_reduce_": True, "scatter_reduce": True,
    "index_put_": None, "index_put": None, "put_": None, "put": None,
    "scatter_": None, "scatter": None, "__setitem__": False,
    "index_copy_": False, "index_copy": False,
}


_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))


def _is_sync_refusal(exc: BaseException) -> bool:
    return isinstance(exc, RuntimeError) and \
        "synchronizing CUDA operation" in str(exc)


def _outside(filename: str) -> bool:
    """A frame of the audited code: not torch's, not this module's."""
    return not (filename.startswith(_TORCH_DIR)
                or filename == os.path.abspath(__file__)
                or filename.startswith("<"))


def _site(filename: str, lineno: int, def_line: int):
    """``(path, line, suppressed)`` of a call site: the repo-relative path
    and whether its line or its function's ``def`` line disables the
    host-callback pass."""
    suppressed = False
    for n in (lineno, def_line):
        m = _DISABLE_RE.search(linecache.getline(filename, n))
        if m and ({PASS_CALLBACK, "all"} & set(m.group(1).split(","))):
            suppressed = True
    path = os.path.relpath(filename, _ROOT) \
        if filename.startswith(_ROOT + os.sep) else filename
    return path.replace(os.sep, "/"), lineno, suppressed


def _caller_site():
    """The call site of the torch call being recorded."""
    f = sys._getframe(2)
    while f is not None and not _outside(os.path.abspath(
            f.f_code.co_filename)):
        f = f.f_back
    if f is None:
        return "<unknown>", 0, False
    return _site(os.path.abspath(f.f_code.co_filename), f.f_lineno,
                 f.f_code.co_firstlineno)


def _traceback_site(exc: BaseException):
    """The innermost audited frame of an exception's traceback."""
    site = ("<unknown>", 0, False)
    tb = exc.__traceback__
    while tb is not None:
        filename = os.path.abspath(tb.tb_frame.f_code.co_filename)
        if _outside(filename):
            site = _site(filename, tb.tb_lineno,
                         tb.tb_frame.f_code.co_firstlineno)
        tb = tb.tb_next
    return site


def _name(func) -> str:
    return getattr(func, "__name__", "") or repr(func)


def _tensors(obj):
    """Every tensor in a (nested) call argument or result."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def is_float_narrowing(src_dtype, dst_dtype) -> bool:
    """True when a conversion loses floating-point precision (f64->f32,
    f32->bf16/f16, float->int).  Integer/bool conversions never count —
    index math legitimately moves between integer widths."""
    if src_dtype is None or dst_dtype is None or not src_dtype.is_floating_point:
        return False
    if not dst_dtype.is_floating_point:
        return True                 # float -> int truncates outright
    return dst_dtype.itemsize < src_dtype.itemsize


def _target_device(args, kwargs):
    """The device a ``.to`` call names explicitly, else None."""
    dev = kwargs.get("device")
    for a in args[1:]:
        if isinstance(a, (str, torch.device)):
            dev = a
    if dev is None:
        return None
    try:
        return torch.device(dev)
    except (RuntimeError, TypeError):
        return None


@contextlib.contextmanager
def _sync_debug_off():
    """The recorder's own device reads, outside the card's sync check."""
    if not torch.cuda.is_available():
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _has_duplicates(columns) -> bool:
    """True when the rows of the broadcast index ``columns`` repeat."""
    columns = torch.broadcast_tensors(*columns)
    keys = torch.stack([c.reshape(-1).to(torch.int64) for c in columns], 1)
    if keys.shape[0] < 2:
        return False
    return torch.unique(keys, dim=0).shape[0] < keys.shape[0]


def _index_columns(name, args, kwargs):
    """The index tensors (as broadcastable columns) a non-accumulating
    indexed write targets, or None when it has none."""
    if name == "__setitem__":
        key = args[1]
        key = key if isinstance(key, tuple) else (key,)
        cols = [k for k in key if isinstance(k, torch.Tensor)
                and not k.dtype.is_floating_point and k.dtype != torch.bool]
        if len(cols) == 1 and len(key) == 1 and args[0].dim():
            cols = [cols[0] % args[0].shape[0]]
        return cols or None
    if name in ("index_put_", "index_put"):
        return [i for i in args[1] if i is not None] or None
    if name in ("put_", "put"):
        return [args[1] % max(1, args[0].numel())]
    if name in ("index_copy_", "index_copy"):
        return [args[2]]
    if name in ("scatter_", "scatter"):
        dim, index = args[1], args[2]
        dim = dim % index.dim() if index.dim() else 0
        grids = torch.meshgrid(*(torch.arange(s, device=index.device)
                                 for s in index.shape), indexing="ij")
        return [index if d == dim else g for d, g in enumerate(grids)]
    return None


def _accumulates(name, args, kwargs) -> bool:
    fixed = INDEXED_WRITES[name]
    if fixed is not None:
        return fixed
    if name in ("index_put_", "index_put", "put_", "put"):
        acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
        return bool(acc)
    return "reduce" in kwargs or len(args) > 4     # scatter with a reduce


class OpRecorder(TorchFunctionMode):
    """Records and audits every torch call made while it is entered."""

    def __init__(self, *, path: str, symbol: str):
        super().__init__()
        self.path = path
        self.symbol = symbol
        self.calls = 0
        self.findings: list[Finding] = []
        self.writes: list[dict] = []
        #: refused synchronisations whose call site disables the pass
        self.suppressed: list[str] = []
        self._taint = WeakIdKeyDictionary()

    def _flag(self, pass_id, message, *, path=None, line=0):
        self.findings.append(Finding(pass_id=pass_id,
                                     path=path or self.path,
                                     symbol=self.symbol, line=line,
                                     message=message))

    def refused(self, what: str, site) -> None:
        """One synchronisation the card refused, at ``site``."""
        path, line, suppressed = site
        if suppressed:
            self.suppressed.append(f"{path}:{line}: {what}")
            return
        self._flag(PASS_CALLBACK,
                   f"the card refused an implicit synchronisation in the "
                   f"hot path (sync debug mode 'error'): {what} at "
                   f"{path}:{line}", path=path, line=line)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        self.calls += 1
        hosted = self._check_host(name, args, kwargs)
        if name in INDEXED_WRITES and args \
                and isinstance(args[0], torch.Tensor):
            self._record_write(name, args, kwargs)
        taint = next((self._taint[t] for t in _tensors((args, kwargs))
                      if t in self._taint), None)
        try:
            out = func(*args, **kwargs)
        except RuntimeError as exc:
            if not _is_sync_refusal(exc):
                raise
            if not hosted:
                self.refused(f"'{name}'", _caller_site())
            with _sync_debug_off():         # complete the refused call
                out = func(*args, **kwargs)
        if name in CONVERSIONS or "dtype" in kwargs:
            narrowed = self._narrowing(name, args, out)
            taint = taint or narrowed
        if taint is None:
            return out
        if name in ACCUMULATIONS or (name in INDEXED_WRITES and _accumulates(
                name, args, kwargs)):
            self._flag(PASS_NARROWING,
                       f"accumulation '{name}' consumes a value that passed "
                       f"through a narrowing conversion ({taint}); "
                       f"accumulate at the promoted dtype instead")
        for t in _tensors(out):
            self._taint[t] = taint
        if name.endswith("_") and not name.startswith("__") or \
                name == "__setitem__":
            if args and isinstance(args[0], torch.Tensor):
                self._taint[args[0]] = taint        # written in place
        return out

    def _check_host(self, name, args, kwargs):
        src = args[0] if args and isinstance(args[0], torch.Tensor) else None
        msg = None
        if name in HOST_READS and src is not None:
            msg = f"'{name}' reads a {src.device.type} tensor on the host"
        elif name == "to" and src is not None:
            dst = _target_device(args, kwargs)
            if dst is not None and dst.type == "cpu":
                msg = (f"'.to({dst})' copies a {src.device.type} tensor to "
                       f"the host")
        elif name == "copy_" and src is not None and len(args) > 1 \
                and isinstance(args[1], torch.Tensor) \
                and src.device.type == "cpu" \
                and args[1].device.type != "cpu":
            msg = "'copy_' copies a device tensor into host memory"
        if msg is not None:
            self._flag(PASS_CALLBACK,
                       f"host transfer in the hot path: {msg}, one "
                       f"device-to-host round-trip per dispatch")
        return msg is not None

    def _narrowing(self, name, args, out):
        tensors = [t for t in _tensors(args) if t.dtype.is_floating_point]
        if name == "copy_" and len(args) > 1:
            src, dst = args[1], args[0]
        else:
            src = tensors[0] if tensors else None
            dst = next(_tensors(out), None)
        if not isinstance(src, torch.Tensor) or dst is None:
            return None
        if is_float_narrowing(src.dtype, dst.dtype):
            return f"{src.dtype} -> {dst.dtype} in '{name}'"
        return None

    def _record_write(self, name, args, kwargs):
        accumulate = _accumulates(name, args, kwargs)
        fact = {"op": name, "accumulate": accumulate,
                "out_shape": tuple(args[0].shape), "duplicates": None}
        if not accumulate:
            with _sync_debug_off():
                cols = _index_columns(name, args, kwargs)
                if cols is None:
                    return          # slices, masks: no indexed write
                fact["duplicates"] = _has_duplicates(cols)
            if fact["duplicates"]:
                self._flag(PASS_CONFLICT,
                           f"non-accumulating indexed write '{name}' into "
                           f"{fact['out_shape']} with duplicate indices: "
                           f"the last writer wins, in an order the device "
                           f"does not fix")
        self.writes.append(fact)


def audit_hot_path(hot_path, *, recorder: OpRecorder | None = None
                   ) -> list[Finding]:
    """The three audits over one :class:`~.hotpaths.HotPath`, and on the
    card the sync debug mode at ``"error"`` around the path: an implicit
    synchronisation the card refuses is a host-callback finding."""
    rec = recorder if recorder is not None else OpRecorder(
        path=hot_path.path, symbol=hot_path.name)
    on_card = hot_path.device.type == "cuda"
    mode = torch.cuda.get_sync_debug_mode() if on_card else 0
    try:
        with rec:
            if on_card:
                torch.cuda.set_sync_debug_mode("error")
            try:
                hot_path.run()
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(mode)
    except RuntimeError as exc:
        # a refusal outside any torch call the recorder sees (a stream's
        # synchronize, say) ends the path where it happened
        if not on_card or not _is_sync_refusal(exc):
            raise
        rec.refused(traceback.format_exception_only(exc)[-1].strip(),
                    _traceback_site(exc))
    if on_card:
        torch.cuda.synchronize()
    return rec.findings
