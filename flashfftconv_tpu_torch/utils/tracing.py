"""The port's own spans and counters, on torch.profiler's clock.

    from flashfftconv_tpu_torch.utils import tracing

    tracing.enable()
    step(x, y)                      # spans: step > step.forward > model > block > mixer > ...
    tracing.disable()
    rec = tracing.collect()         # {"spans": [...], "counters": {unit id: {name: n}}}

``span(name, **attrs)`` is a context manager at a call site. It records the
name, start and end, the thread, the enclosing span and a unit id: spans of
one unit (a train step, a scoring request) share the id of its root span,
which is ``step``, ``score`` or ``model`` where nothing encloses it. A span
that opens with nothing around it on its thread takes the current unit and,
as parent, the innermost span open on the unit's own thread: the backward's
spans on autograd's thread hang under ``step.backward`` so. ``count(name,
n)`` adds to a counter of the current unit. Records stay in memory until
``collect()`` takes them; nothing is written anywhere.

Off, the default: ``span`` tests one flag and hands back a shared object
whose ``inputs``/``outputs`` return their arguments, so the graph, the
outputs and the gradients are the untraced program's. There is no
environment variable; whoever wants the trace calls ``enable()``.

On: the spans that mark their tensors (``s.inputs(...)`` and
``s.outputs(...)``) also record their backward as ``<name>.bwd`` on the
thread that runs it. An identity autograd Function on each output opens it
when the output's gradient arrives, one on each input closes it when the
input's gradient leaves; a site with no input that needs a gradient closes
at the next mark of a site outside it. A forward span opened inside the
backward (a checkpoint's recomputation) carries ``recompute=True``. The root
spans read the caching allocator's ``num_device_alloc`` + ``num_device_free``
at their open and close, on the card only, and count the growth as
``device_allocs``.

The clock is the one torch.profiler reports every host event and every
CUPTI device record on: nanoseconds of the Unix epoch (``time.time_ns()``).
So a kernel's launch, and a gap in the device's timeline, can be placed in a
span by time and thread. ``thread`` is the OS thread id and ``ident`` the
Python one; the profiler names a launch's thread by one or the other.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

ROOTS = ("step", "score", "model")

_clock = time.time_ns
_current_node = getattr(torch._C, "_current_autograd_node", lambda: None)


class _Off:
    """The span of every call site while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def inputs(*tensors):
        return tensors[0] if len(tensors) == 1 else tensors

    outputs = inputs


_OFF = _Off()


class _Record:
    __slots__ = ("id", "name", "start", "end", "thread", "ident", "parent", "unit", "attrs",
                 "site", "allocs")

    def __init__(self, name, attrs, thread, parent, root):
        self.id = next(_state.ids)
        self.name, self.attrs, self.end, self.site, self.allocs = name, attrs, None, None, None
        self.thread, self.ident = thread.native, thread.ident
        self.parent = parent
        self.unit = self.id if root else (parent.unit if parent else _state.unit)
        self.start = _clock()
        _state.spans.append(self)

    def as_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "start_ns": self.start, "end_ns": self.end,
                "thread": self.thread, "ident": self.ident,
                "parent": self.parent.id if self.parent else None, "unit": self.unit,
                **({"attrs": self.attrs} if self.attrs else {})}


class _Thread(threading.local):
    def __init__(self):
        self.stack: list[_Record] = []
        self.native, self.ident = threading.get_native_id(), threading.get_ident()


class _State:
    def __init__(self):
        self.on = False
        self.ids = itertools.count(1)
        self.spans: list[_Record] = []
        self.counters: dict[int, dict[str, int]] = {}
        self.lock = threading.Lock()
        self.unit = None  # id of the last root opened
        self.unit_stack: list[_Record] = []  # the open spans of that root's thread
        self.open_sites: list[_Site] = []  # backward spans open, on any thread
        self.cuda_stats = False


_state = _State()
_thread = _Thread()


def enable() -> None:
    """Start recording spans and counters (all threads)."""
    _state.cuda_stats = torch.cuda.is_available() and torch.cuda.is_initialized()
    _state.on = True


def disable() -> None:
    """Stop recording; spans still open record their end when they close."""
    _state.on = False


def collect() -> dict:
    """The spans recorded so far (``id``, ``name``, ``start_ns``, ``end_ns``
    on the profiler's clock, ``thread``, ``ident``, ``parent``, ``unit``, and
    ``attrs`` when any), in the order they opened, and the counters by unit;
    clears both. A span still open has ``end_ns`` None."""
    spans, counters = _state.spans, _state.counters
    _state.spans, _state.counters = [], {}
    return {"spans": [r.as_dict() for r in spans], "counters": counters}


def count(name: str, n: int = 1) -> None:
    """Add n to counter ``name`` of the current unit (while tracing is on)."""
    if not _state.on or _state.unit is None:
        return
    with _state.lock:
        unit = _state.counters.setdefault(_state.unit, {})
        unit[name] = unit.get(name, 0) + n


def _device_allocs() -> int:
    stats = torch.cuda.memory_stats()
    return stats.get("num_device_alloc", 0) + stats.get("num_device_free", 0)


def _open(name: str, attrs: dict) -> _Record:
    t = _thread
    stack = t.stack
    if stack:
        rec = _Record(name, attrs, t, stack[-1], False)
    else:
        root = name in ROOTS and _current_node() is None
        parent = _state.unit_stack[-1] if (_state.unit_stack and not root) else None
        rec = _Record(name, attrs, t, parent, root)
        if root:
            _state.unit, _state.unit_stack = rec.id, stack
            if _state.cuda_stats:
                rec.allocs = _device_allocs()
    stack.append(rec)
    return rec


def _close(rec: _Record, stack: list[_Record]) -> None:
    """End ``rec`` and whatever its thread still has open above it."""
    if rec not in stack:
        return
    end = _clock()
    while stack:
        top = stack.pop()
        top.end = end
        if top.site is not None:
            _state.open_sites.remove(top.site)
        if top is rec:
            break
    if rec.allocs is not None:
        count("device_allocs", _device_allocs() - rec.allocs)
        rec.allocs = None
    if rec.id == rec.unit:  # a backward span left open ends with its unit
        for site in list(_state.open_sites):
            _close(site.rec, site.stack)


class _Span:
    __slots__ = ("name", "attrs", "rec", "bwd")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.rec, self.bwd = name, attrs, None, None

    def __enter__(self):
        if _current_node() is not None:
            self.attrs["recompute"] = True
        self.rec = _open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        _close(self.rec, _thread.stack)
        return False

    def _site(self) -> _Site:
        if self.bwd is None:
            self.bwd = _Site(self.name + ".bwd", self.rec)
        return self.bwd

    def inputs(self, *tensors):
        """``tensors``, each that needs a gradient behind an identity whose
        backward closes this span's ``.bwd``."""
        out = tuple(_mark(t, self._site(), _CloseBwd) for t in tensors)
        return out[0] if len(out) == 1 else out

    def outputs(self, *tensors):
        """``tensors``, each that needs a gradient behind an identity whose
        backward opens this span's ``.bwd``."""
        out = tuple(_mark(t, self._site(), _OpenBwd) for t in tensors)
        return out[0] if len(out) == 1 else out


class _Site:
    """The backward of one forward span: opened by the first of its outputs'
    marks to fire, closed when every input mark has fired."""

    __slots__ = ("name", "fwd", "pending", "rec", "stack")

    def __init__(self, name: str, fwd: _Record):
        self.name, self.fwd, self.pending, self.rec, self.stack = name, fwd, 0, None, None

    def inside(self, other: _Site) -> bool:
        """Whether this site's forward span lies inside ``other``'s."""
        r = self.fwd
        while r is not None:
            if r is other.fwd:
                return True
            r = r.parent
        return False

    def open(self) -> None:
        if self.rec is not None or not _state.on:
            return
        stack = _thread.stack
        # a site with no input mark left ends at the next mark of a site outside it
        while stack and stack[-1].site is not None:
            top = stack[-1].site
            if top.pending or self.inside(top):
                break
            _close(stack[-1], stack)
        r = self.fwd  # the layer of the nearest forward span that has one
        while r is not None and "layer" not in r.attrs:
            r = r.parent
        self.rec = _open(self.name, {} if r is None else {"layer": r.attrs["layer"]})
        self.rec.site, self.stack = self, stack
        _state.open_sites.append(self)

    def close(self) -> None:
        self.pending -= 1
        if self.pending == 0 and self.rec is not None:
            _close(self.rec, self.stack)


class _OpenBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, site, x):
        ctx.site = site
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.site.open()
        return None, g


class _CloseBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, site, x):
        ctx.site = site
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.site.close()
        return None, g


def _mark(t, site: _Site, fn):
    if not (torch.is_tensor(t) and t.requires_grad and torch.is_grad_enabled()):
        return t
    if fn is _CloseBwd:
        site.pending += 1
    return fn.apply(site, t)


def span(name: str, **attrs):
    """A span over the ``with`` block (module docstring); while tracing is
    off, one flag test."""
    if not _state.on:
        return _OFF
    return _Span(name, attrs)
