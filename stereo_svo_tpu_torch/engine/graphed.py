"""The graph-captured per-frame step — the counterpart of the reference's
``make_jitted_step`` (``jax.jit(make_step(cfg), donate_argnums=(0,))``) —
and its batched form, the counterpart of the jitted ``make_batched_step``.

JAX compiles the step once and donates the state's buffers, so a frame
reuses them. Here every phase of a frame after the bootstrap is captured
once as a CUDA graph over static buffers, and a frame replays them:

* ``P``: ``pyramid.build_with_gradients`` of the left image (kernels B1,
  B2). Its captured outputs are the static pyramid, which both track
  variants, the keyframe phase and ``B`` read, so it needs no copy;
* ``A_ok`` / ``A_fail``: ``track_phase`` with ``prev_ok`` True / False
  (False adds the rotated relocalisation variants), its state copied into
  the static ``S'`` and its ``TrackCtx`` into a static one (B3, B4);
* ``K`` / ``K_loop``: ``kf_phase`` on ``S'`` — ``keyframe.insert`` (B3 in
  the stereo match) and, with ``use_ba``, window BA; ``K_loop`` adds the
  online loop closure (B2, B3, B4 at the thumbnail, the pose graph) and is
  captured only when ``online_loop_every > 0`` — its state copied back
  into ``S'``;
* ``B``: ``post_phase`` on ``S'``, its state copied back into the live
  state ``S`` (what donation is to JAX) and its ``FrameOut`` into a static
  one (B3: the template rebuild).

A tracked frame runs: replay ``P``; replay ``A_ok`` or ``A_fail`` (the
host's copy of the previous frame's ``tracking_ok``); the step's one host
sync (``step._read_decisions``); on a keyframe frame, replay ``K``, or
``K_loop`` when the sync says the online loop is due; replay ``B``. The
bootstrap frame, once a sequence, replays ``P`` and runs ``boot``
eagerly, its state copied into ``S``.

``S'`` has a buffer of its own for every field of the state: graph A
copies the whole tracked state into it, graph K reads and rewrites it,
and graph B copies the whole new state back.

The graphs are captured when the step is made, on one side stream after a
warm-up of every body on that stream (which also allocates B4's scratch
for it, ``align_kernel._scratch``, and pays the first ``jacfwd``'s
set-up), into one memory pool, in the order ``P``, ``A_ok``, ``A_fail``,
``K``, ``K_loop``, ``B``. The data that passes between graphs lives in
buffers allocated outside the pool (``S``, ``S'``, the context, the
output) or in the pyramid, which stays referenced; a graph's pool memory
holds only its own temporaries (window BA's reduced system among them),
so the graphs may replay in any order, one at a time. Capture
synchronises, so it happens here and never inside a frame.

The batched step (:class:`GraphedBatchedStep`) captures the same six
graphs once for the whole batch, over one stacked set of static buffers:
its bodies are the ``torch.func.vmap``ped phases of
``step.make_batched_phases``, so each kernel node takes the B sequences
as its problem axis (the reference's jitted ``vmap``).

The host's launch counters (``pyramid_kernel.LAUNCHES``,
``align_kernel.LAUNCHES``) do not move on a replay. After each capture the
graph's kernel nodes are read back through libcuda by function name
(:func:`scan`); they must equal the launches the wrappers counted while
capturing (capture raises otherwise), and each replay adds them.

On the CPU the same objects run the same bodies directly on the same
static buffers, with no capture: the graphs' plain version, on which the
tests hold the copies to the eager ``step.make_step`` and
``step.make_batched_step`` bit for bit. On CUDA there is no eager
fallback: a capture or a replay that fails raises.

The returned state is the live buffers and the returned ``FrameOut`` the
static one: the next frame overwrites both, so a caller that keeps either
across frames clones it.
"""

from __future__ import annotations

import ctypes
import gc
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..config import SvoConfig
from ..device import resolve
from ..ops import pyramid
from ..ops.kernels import align_kernel, pyramid_kernel
from .state import FrameOut, SlamState, init_state, init_states
from .step import (HostFlags, _read_decisions, host_flags,
                   host_flags_batched, make_batched_phases, make_phases)

COUNTERS = (pyramid_kernel.LAUNCHES, align_kernel.LAUNCHES)
KERNELS = {**pyramid_kernel.KERNELS, **align_kernel.KERNELS}
_COUNTER = {key: counts for counts in COUNTERS for key in counts}
GRAPHS = ("P", "A_ok", "A_fail", "K", "K_loop", "B")
# CUgraphNodeType (cuda.h) of the node kinds a capture may record
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
               4: "graph", 5: "empty", 6: "wait_event", 7: "event_record",
               10: "mem_alloc", 11: "mem_free", 13: "conditional"}


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""
    _fields_ = [("func", ctypes.c_void_p), ("dims", ctypes.c_uint * 7),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a NamedTuple tree (nested ones too), in field
    order."""
    out = []
    for v in tree:
        out.extend(_leaves(v) if isinstance(v, tuple) else [v])
    return out


def _tree(like, leaves):
    """``like``'s structure over the tensors of the iterator ``leaves``."""
    return type(like)(*(_tree(v, leaves) if isinstance(v, tuple)
                        else next(leaves) for v in like))


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr() if t.numel() else 0


def _copy_into(dst: List[torch.Tensor], src) -> None:
    """Copy the leaves of ``src`` into the buffers ``dst``. A leaf that is
    its buffer already is skipped; one that lies in any of the buffers (a
    view, or another field's buffer) is cloned before the first copy, so
    every leaf is read as it was. Shapes and dtypes must match: a buffer
    never converts."""
    buffers = {_storage(d) for d in dst} - {0}
    pairs = []
    for d, s in zip(dst, _leaves(src), strict=True):
        if s is d:
            continue
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(f"static buffer {tuple(d.shape)} {d.dtype} "
                             f"cannot take {tuple(s.shape)} {s.dtype}")
        if s.device == d.device and _storage(s) in buffers:
            s = s.clone()
        pairs.append((d, s))
    for d, s in pairs:
        d.copy_(s)


def _counts() -> Dict[str, int]:
    """Every launch counter, by kernel."""
    return {key: counts[key] for key, counts in _COUNTER.items()}


def _set_counts(values: Dict[str, int]) -> None:
    for key, v in values.items():
        _COUNTER[key][key] = v


def counter_of(function: str) -> Optional[str]:
    """The launch counter of the kernel that the CUDA function name
    ``function`` names — mangled, as libcuda gives it, or demangled, as
    torch.profiler does — or None for any other function."""
    for key, name in KERNELS.items():
        if (f"{len(name)}{name}" in function if function.startswith("_Z")
                else re.search(rf"(?<!\w){name}(?!\w)", function)):
            return key
    return None


def _nodes(graph: torch.cuda.CUDAGraph):
    """(kind, CUDA function name — mangled, as libcuda gives it — or None
    for a node that is no kernel) of every node of a captured graph, read
    from the graph through libcuda."""
    drv = ctypes.CDLL("libcuda.so.1")
    ptr = ctypes.c_void_p

    def call(fn, *args):
        err = getattr(drv, fn)(*args)
        if err:
            raise RuntimeError(f"{fn} failed: CUresult {err}")

    raw, n = ptr(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    call("cuGraphGetNodes", raw, None, ctypes.byref(n))
    nodes = (ptr * n.value)()
    call("cuGraphGetNodes", raw, nodes, ctypes.byref(n))
    names = {}                          # function handle -> name
    for node in nodes:
        t = ctypes.c_int(-1)
        call("cuGraphNodeGetType", ptr(node), ctypes.byref(t))
        kind = _NODE_TYPES.get(t.value, "other")
        if kind != "kernel":
            yield kind, None
            continue
        p = _KernelNodeParams()
        call("cuGraphKernelNodeGetParams_v2", ptr(node), ctypes.byref(p))
        handle = ("func", p.func) if p.func else ("kern", p.kern)
        if handle not in names:
            name = ctypes.c_char_p()
            call("cuFuncGetName" if p.func else "cuKernelGetName",
                 ctypes.byref(name), ptr(handle[1]))
            names[handle] = name.value.decode()
        yield kind, names[handle]


def scan(graph: torch.cuda.CUDAGraph
         ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """(nodes by kind — "kernel", "memcpy", "memset", "other" and any
    other kind of ``_NODE_TYPES`` the graph holds — and kernel nodes by
    launch counter) of a captured graph, read from the graph through
    libcuda: each kernel node's function and that function's name."""
    kinds = dict.fromkeys(("kernel", "memcpy", "memset", "other"), 0)
    kernels = dict.fromkeys(KERNELS, 0)
    for kind, name in _nodes(graph):
        kinds[kind] = kinds.get(kind, 0) + 1
        key = counter_of(name) if name is not None else None
        if key is not None:
            kernels[key] += 1
    return kinds, kernels


def kernel_names(graph: torch.cuda.CUDAGraph) -> Dict[str, int]:
    """A captured graph's kernel nodes by CUDA function name (mangled):
    what two graphs' node counts differ by."""
    out: Dict[str, int] = {}
    for kind, name in _nodes(graph):
        if name is not None:
            out[name] = out.get(name, 0) + 1
    return out


def capture(body: Callable[[], object], pool, stream: torch.cuda.Stream
            ) -> Tuple[torch.cuda.CUDAGraph, object, Dict[str, int]]:
    """Capture ``body()`` on ``stream`` into ``pool``: (the instantiated
    graph, what the body returned — tensors that replays overwrite — and
    the launches the wrappers counted during capture, which are taken
    back from the counters). A body that synchronises, reads the device or
    does anything else capture refuses raises here."""
    before = _counts()
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # for scan
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            out = body()
    finally:
        after = _counts()
        _set_counts(before)
    graph.instantiate()
    return graph, out, {k: after[k] - before[k] for k in before}


def _capture_graphs(step) -> Tuple[float, int]:
    """Capture every graph of ``step`` (a :class:`GraphedStep` or
    :class:`GraphedBatchedStep`) into one pool on one side stream: first
    a warm-up of every body on that stream (lazy state, B4's scratch for
    the stream, cuSOLVER's and cuBLAS's handles, the first ``jacfwd``'s
    set-up), then the captures in ``GRAPHS`` order, each graph's kernel
    nodes held to what its capture counted. Capture synchronises, so it
    happens here and never inside a frame. The warm-up writes into the
    live state, which is reset to the initial state at the end. Returns
    (seconds, bytes the pool holds)."""
    t0 = time.perf_counter()
    dev = step.device
    with torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        saved = _counts()
        with torch.cuda.stream(side):
            for name in step.graph_names:
                step._body(name)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        _set_counts(saved)          # the warm-up is set-up, not a frame
        # a CUDA graph destroyed during a capture invalidates it: free the
        # dead ones now and keep the cyclic collector out of the captures
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            torch.cuda.empty_cache()
            base = torch.cuda.memory_reserved(dev)
            pool = torch.cuda.graph_pool_handle()
            # P first: the pyramid outlives its capture, and in memory that
            # a graph captured before it used for temporaries, that graph's
            # replays would overwrite it
            for name in step.graph_names:
                graph, _, counted = capture(
                    lambda: step._body(name), pool, side)
                step.nodes[name], step.kernel_nodes[name] = scan(graph)
                if step.kernel_nodes[name] != counted:
                    raise RuntimeError(
                        f"graph {name} holds the kernel nodes "
                        f"{step.kernel_nodes[name]}, but its capture "
                        f"counted the launches {counted}")
                step.graphs[name] = graph
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(dev)
        pool_bytes = torch.cuda.memory_reserved(dev) - base
        step.reset()
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, pool_bytes


class GraphedStep:
    """``step(state, img_l, img_r, flags=None) -> (state, FrameOut,
    flags)``, ``make_step``'s signature, on static buffers (module
    docstring). Images are (H,W) at the configuration's camera size.

    A frame is :meth:`track`, the host's read of its decisions
    (``step._read_decisions`` of :attr:`tracked`), then :meth:`finish`;
    ``__call__`` runs the three."""

    def __init__(self, cfg: SvoConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve(device)
        self._boot, self._track, self._kf, self._post = make_phases(cfg)
        self.state: SlamState = init_state(cfg, self.device)  # S, live
        self._s = _leaves(self.state)
        self._s1 = [torch.empty_like(x) for x in self._s]     # S', staged
        self._ctx: Optional[List[torch.Tensor]] = None
        self._ctx_like = None
        self._out: Optional[FrameOut] = None
        hw = (cfg.camera.height, cfg.camera.width)
        self._img_l = torch.zeros(hw, dtype=torch.float32, device=self.device)
        self._img_r = torch.zeros_like(self._img_l)
        self._pyr = None
        # the graphs this configuration runs, in capture order (each body
        # reads what the ones before it made)
        self.graph_names = tuple(g for g in GRAPHS if g != "K_loop"
                                 or cfg.online_loop_every > 0)
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self.replays = dict.fromkeys(GRAPHS, 0)  # (CPU: body runs)
        self.nodes: Dict[str, Dict[str, int]] = {}         # scan(), by kind
        self.kernel_nodes: Dict[str, Dict[str, int]] = {}  # by counter
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        if self.device.type == "cuda":
            self.capture_seconds, self.pool_bytes = _capture_graphs(self)

    # --- the bodies: a phase, then copies into the static buffers ---

    def _body(self, name: str) -> None:
        """Run graph ``name``'s body. (Dispatched by name: bodies bound to
        the step and kept on it would make a reference cycle, and a step
        freed by the cyclic collector during another step's capture would
        destroy its graphs there, which invalidates that capture.)"""
        if name == "P":
            self._body_p()
        elif name in ("A_ok", "A_fail"):
            self._body_a(name == "A_ok")
        elif name in ("K", "K_loop"):
            self._body_k(name == "K_loop")
        else:
            self._body_b()

    def _body_p(self) -> None:
        # captured, its outputs are the static pyramid
        self._pyr = pyramid.build_with_gradients(self._img_l,
                                                 self.cfg.num_levels)

    def _body_a(self, prev_ok: bool) -> None:
        st, ctx = self._track(self.state, *self._pyr, self._img_r,
                              prev_ok=prev_ok)
        _copy_into(self._s1, st)
        if self._ctx is None:
            self._ctx_like = ctx
            self._ctx = [torch.empty_like(x) for x in _leaves(ctx)]
        _copy_into(self._ctx, ctx)

    def _body_k(self, run_loop: bool) -> None:
        # reads S' and writes it: _copy_into clones what lies in it
        _copy_into(self._s1, self._kf(self._staged(), *self._pyr,
                                      self._img_r, self.context.T_cw,
                                      run_loop))

    def _body_b(self) -> None:
        st, out = self._post(self._staged(), *self._pyr, self.context)
        _copy_into(self._s, st)
        if self._out is None:
            self._out = FrameOut(*(torch.empty_like(x) for x in out))
        _copy_into(list(self._out), out)

    def _staged(self) -> SlamState:
        """S' as a SlamState."""
        return _tree(self.state, iter(self._s1))

    @property
    def context(self):
        """The static TrackCtx of the last track phase."""
        return _tree(self._ctx_like, iter(self._ctx))

    @property
    def tracked(self):
        """(S', TrackCtx) of the last track phase: what
        ``step._read_decisions`` reads."""
        return self._staged(), self.context

    # --- replay ---

    def _run(self, name: str) -> None:
        """Replay graph ``name`` (CPU: run its body) and count the
        launches of its kernel nodes."""
        self.replays[name] += 1
        if self.device.type != "cuda":
            self._body(name)
            return
        self.graphs[name].replay()
        for key, n in self.kernel_nodes[name].items():
            _COUNTER[key][key] += n

    def load(self, state: SlamState) -> None:
        """Copy ``state`` into the live buffers (fields that are those
        buffers already are skipped)."""
        _copy_into(self._s, state)

    def reset(self) -> None:
        """Copy the initial state into the live buffers."""
        self.load(init_state(self.cfg, self.device))

    # --- the step ---

    def track(self, state: SlamState, img_l: torch.Tensor,
              img_r: torch.Tensor, flags: Optional[HostFlags] = None
              ) -> HostFlags:
        """The frame's first half: ``state`` copied into the live buffers
        (unless it is those), the images into the static ones, then ``P``
        and, on a booted state, ``A_ok`` or ``A_fail``. Returns the flags
        :meth:`finish` takes."""
        if state is not self.state:
            self.load(state)
        if flags is None:
            flags = host_flags(self.state)
        for buf, img in ((self._img_l, img_l), (self._img_r, img_r)):
            if tuple(img.shape) != tuple(buf.shape):
                raise ValueError(f"image {tuple(img.shape)}: the step was "
                                 f"made for {tuple(buf.shape)}")
            buf.copy_(img)
        self._run("P")
        if flags.booted:
            self._run("A_ok" if flags.tracking_ok else "A_fail")
        return flags

    def finish(self, flags: HostFlags,
               decision: Optional[Tuple[bool, bool, bool]] = None
               ) -> Tuple[SlamState, FrameOut, HostFlags]:
        """The frame's second half. Booted: ``decision`` is (need_kf, ok,
        run the online loop), the host's read of :attr:`tracked`; ``K`` or
        ``K_loop`` when a keyframe is due, then ``B``. Not booted: the
        eager bootstrap, its state copied into the live buffers."""
        if not flags.booted:
            st, out = self._boot(self.state, *self._pyr, self._img_r)
            _copy_into(self._s, st)
            return self.state, out, HostFlags(booted=True, tracking_ok=True)
        need_kf, ok, run_loop = decision
        if need_kf:
            self._run("K_loop" if run_loop else "K")
        self._run("B")
        return self.state, self._out, HostFlags(booted=True, tracking_ok=ok)

    def __call__(self, state: SlamState, img_l: torch.Tensor,
                 img_r: torch.Tensor, flags: Optional[HostFlags] = None
                 ) -> Tuple[SlamState, FrameOut, HostFlags]:
        flags = self.track(state, img_l, img_r, flags)
        decision = (_read_decisions(self.cfg, *self.tracked)[0]
                    if flags.booted else None)
        return self.finish(flags, decision)


class GraphedBatchedStep:
    """``bstep(states, img_l, img_r, flags=None) -> (states, outs,
    flags)``, ``step.make_batched_step``'s signature (a stacked state and
    FrameOut, every field with a leading B axis, (B,H,W) images, a list of
    B HostFlags), on one stacked set of static buffers: the counterpart of
    the reference's jitted batched step.

    Its graphs are those of :class:`GraphedStep`, each captured once over
    the whole batch: the bodies are ``step.make_batched_phases``, every
    phase ``torch.func.vmap``ped over the stacked state, so every kernel
    node takes the B sequences as its problem axis and a graph holds about
    the single step's nodes, not B times them. ``A_fail`` is replayed when
    any booted sequence failed last frame (the rotated relocalisation
    variants count where a sequence's own state failed), ``K`` when any
    needs a keyframe and ``K_loop`` when the online loop is due in any;
    ``where`` keeps each sequence's own result, as the eager batched step
    does. A batched frame reads the decisions of the whole batch once. A
    sequence with no keyframe bootstraps eagerly (``vmap`` of ``boot``,
    kept where the state has no keyframe). The returned state is the live
    buffers and the FrameOut the static one: the next batched frame
    overwrites both."""

    def __init__(self, cfg: SvoConfig, B: int, device="cuda"):
        self.cfg = cfg
        self.B = B
        self.device = resolve(device)
        self._phases = make_batched_phases(cfg)
        self.state: SlamState = init_states(cfg, B, self.device)  # S, live
        self._s = _leaves(self.state)
        self._s1 = [torch.empty_like(x) for x in self._s]        # S'
        self._ctx: Optional[List[torch.Tensor]] = None
        self._ctx_like = None
        self._out: Optional[FrameOut] = None
        hw = (B, cfg.camera.height, cfg.camera.width)
        self._img_l = torch.zeros(hw, dtype=torch.float32, device=self.device)
        self._img_r = torch.zeros_like(self._img_l)
        self._pyr = None
        self.graph_names = tuple(g for g in GRAPHS if g != "K_loop"
                                 or cfg.online_loop_every > 0)
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self.replays = dict.fromkeys(GRAPHS, 0)  # (CPU: body runs)
        self.nodes: Dict[str, Dict[str, int]] = {}
        self.kernel_nodes: Dict[str, Dict[str, int]] = {}
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        if self.device.type == "cuda":
            self.capture_seconds, self.pool_bytes = _capture_graphs(self)

    def _body(self, name: str) -> None:
        """Run graph ``name``'s body (see :meth:`GraphedStep._body`)."""
        ph = self._phases
        if name == "P":
            self._pyr = ph.pyramid(self._img_l)
        elif name in ("A_ok", "A_fail"):
            st, ctx = ph.track(self.state, self._pyr, self._img_r,
                               any_failed=name == "A_fail")
            _copy_into(self._s1, st)
            if self._ctx is None:
                self._ctx_like = ctx
                self._ctx = [torch.empty_like(x) for x in _leaves(ctx)]
            _copy_into(self._ctx, ctx)
        elif name in ("K", "K_loop"):
            _copy_into(self._s1, ph.kf(self._staged(), self._pyr,
                                       self._img_r, self.context,
                                       run_loop=name == "K_loop"))
        else:
            st, out = ph.post(self._staged(), self._pyr, self.context)
            _copy_into(self._s, st)
            if self._out is None:
                self._out = FrameOut(*(torch.empty_like(x) for x in out))
            _copy_into(list(self._out), out)

    _staged = GraphedStep._staged
    context = GraphedStep.context
    tracked = GraphedStep.tracked
    _run = GraphedStep._run
    load = GraphedStep.load

    def reset(self) -> None:
        """Copy the initial states into the live buffers."""
        self.load(init_states(self.cfg, self.B, self.device))

    def __call__(self, states: SlamState, img_l: torch.Tensor,
                 img_r: torch.Tensor,
                 flags: Optional[List[HostFlags]] = None
                 ) -> Tuple[SlamState, FrameOut, List[HostFlags]]:
        if states is not self.state:
            self.load(states)
        if flags is None:
            flags = host_flags_batched(self.state)
        if len(flags) != self.B:
            raise ValueError(f"{len(flags)} sequences: the step was made "
                             f"for {self.B}")
        for buf, img in ((self._img_l, img_l), (self._img_r, img_r)):
            if tuple(img.shape) != tuple(buf.shape):
                raise ValueError(f"images {tuple(img.shape)}: the step was "
                                 f"made for {tuple(buf.shape)}")
            buf.copy_(img)
        self._run("P")
        booted = [f.booted for f in flags]
        if not any(booted):
            st, out = self._phases.boot(self.state, self._pyr, self._img_r)
            _copy_into(self._s, st)
            return self.state, out, [HostFlags(True, True)] * self.B
        failed = not all(f.tracking_ok for f in flags if f.booted)
        self._run("A_fail" if failed else "A_ok")
        decisions = _read_decisions(self.cfg, *self.tracked)
        ours = [d for d, b in zip(decisions, booted) if b]
        if any(need_kf for need_kf, _, _ in ours):
            self._run("K_loop" if any(loop for _, _, loop in ours) else "K")
        before = None
        if not all(booted):      # boot reads S as it was before B
            before = _tree(self.state, iter([x.clone() for x in self._s]))
        self._run("B")
        out = self._out
        if before is not None:
            st, out = self._phases.boot(before, self._pyr, self._img_r,
                                        (self.state, self._out))
            _copy_into(self._s, st)
        return self.state, out, [HostFlags(True, ok or not b) for
                                 (_, ok, _), b in zip(decisions, booted)]


def make_graphed_step(cfg: SvoConfig, device="cuda") -> GraphedStep:
    """The per-frame step on static buffers, captured as CUDA graphs on a
    CUDA device (run directly on the CPU):
    ``step(state, img_l, img_r, flags=None) -> (state, FrameOut, flags)``.
    The returned state is ``step.state``, the live buffers; a ``state``
    argument that is not those is copied into them first."""
    return GraphedStep(cfg, device)


def make_graphed_batched_step(cfg: SvoConfig, B: int, device="cuda"
                              ) -> GraphedBatchedStep:
    """The counterpart of ``step.make_batched_step`` on one stacked set of
    static buffers, its phases captured once for the whole batch:
    ``bstep(states, img_l, img_r, flags=None) -> (states, outs, flags)``
    with one host sync per batched frame."""
    return GraphedBatchedStep(cfg, B, device)


__all__ = ["make_graphed_step", "make_graphed_batched_step", "GraphedStep",
           "GraphedBatchedStep", "capture", "scan", "kernel_names",
           "counter_of", "GRAPHS",
           "KERNELS"]
