"""The graph-captured per-frame step — the counterpart of the reference's
``make_jitted_step`` (``jax.jit(make_step(cfg), donate_argnums=(0,))``) —
and its batched form, the counterpart of the jitted ``make_batched_step``.

JAX compiles the step once, keeps every branch of a frame on the device
(``lax.cond``) and donates the state's buffers, so a frame reuses them.
Here every phase of a frame is captured once as a CUDA graph of its own
(a body) over static buffers, and the bodies are assembled into one frame
graph ``F`` whose conditional (IF) nodes take the place of the ``lax.cond``
branches: a frame is one launch of ``F``, with no host read.

The bodies, in the order ``F`` runs them:

* ``P``: ``pyramid.build_with_gradients`` of the left image (kernels B1,
  B2). Its captured outputs are the static pyramid, which every later
  body reads, so it needs no copy. Runs every frame;
* ``flags``: ``step.device_flags`` of the live state ``S`` (booted, the
  previous frame's ``tracking_ok``) into the static predicates of the
  bodies below, and the frame's count. Runs every frame;
* ``boot`` (``!booted``): the bootstrap on ``S``, its state copied back
  into ``S`` and its ``FrameOut`` into the static one (B3);
* ``A_ok`` (``booted & prev_ok``) / ``A_fail`` (``booted & !prev_ok``):
  ``track_phase`` with ``prev_ok`` True / False (False adds the rotated
  relocalisation variants), its state copied into the static ``S'`` and
  its ``TrackCtx`` into a static one, then ``step.device_decisions`` into
  the predicates of ``K`` and ``K_loop`` (B3, ``align_levels``,
  ``klt_track``, ``refine_pose``);
* ``K`` (``need_kf & !run_loop``) / ``K_loop`` (``run_loop``): ``kf_phase``
  on ``S'`` — ``keyframe.insert`` (B3 in the stereo match) and, with
  ``use_ba``, window BA; ``K_loop`` adds the online loop closure (B2, B3,
  ``align_levels`` at the thumbnail, the pose graph) and exists only when
  ``online_loop_every > 0`` — its state copied back into ``S'``;
* ``B`` (``booted``): ``post_phase`` on ``S'``, its state copied back into
  ``S`` (what donation is to JAX) and its ``FrameOut`` into the static one
  (B3: the template rebuild).

Every predicate is a static bool written by a body before the node that
reads it: ``flags`` writes those of ``boot``, ``A_ok``, ``A_fail`` and
``B`` (and clears ``K``'s and ``K_loop``'s) before ``boot`` changes the
state, the track bodies those of ``K`` and ``K_loop``. A one-block kernel
node of ``csrc/frame_graph.cu`` sets the IF nodes' handles from them
(``cudaGraphSetConditional``), once after ``flags`` and once after the
track bodies. ``S'`` has a buffer of its own for every field of the state.

The bodies are captured when the step is made, on one side stream after a
warm-up of every body on that stream (which also pays the first
``jacfwd``'s set-up), into one memory pool, ``P`` first (the pyramid
outlives its capture). The data that passes between bodies lives in buffers
allocated outside the pool (``S``, ``S'``, the context, the output, the
predicates) or in the pyramid, which stays referenced; a body's pool memory
holds only its own temporaries. ``F`` clones the bodies' graphs as
child-graph nodes and is the only graph instantiated. A conditional body
may hold only kernel, memset, device-to-device memcpy, empty, child-graph
and conditional nodes: capture raises on a body that holds any other kind
(a memory allocation or free, a host or an event node), and building ``F``
raises on a card or CUDA without conditional nodes (12.4 and later have
them). Capture synchronises, so it happens here and never inside a frame.

The batched step (:class:`GraphedBatchedStep`) captures the same bodies
once for the whole batch, over one stacked set of static buffers: its
bodies are the ``torch.func.vmap``ped phases of
``step.make_batched_phases``, so each kernel node takes the B sequences
as its problem axis (the reference's jitted ``vmap``), and its predicates
are the reference's batch-level conds (``step.device_flags_batched``,
``step.device_decisions_batched``).

Spans and launch accounting. The host does not know which bodies a frame
ran, and the launch counters (``ops/kernels.counters``) do not move on
a launch of ``F``. Instead ``F``
stamps its own span table (:class:`_Spans`): one-thread kernel nodes that
read the device's ``%globaltimer`` open and close the frame and every body
(in the outer chain for ``P`` and ``flags``, inside the IF node's body
graph for the others, around the body's child-graph node, so :func:`scan`
of a body sees none). The table holds each body's runs and summed
nanoseconds and a ring of the last :data:`RING` frames, one row a frame:
its start and end and each body's time in it (the ``svo.frame`` and
``svo.body.<name>`` spans). The host keeps a ring of its own, indexed by
the launch count, so host row k and device row k are one frame: the
step's call (``svo.step``: the image copies and the launch) and the launch
of ``F`` in it (``svo.step.launch``), each a ``record_function`` range
where a profiler is on. After each capture the body's kernel nodes are
read back through libcuda by function name (:func:`scan`); they must equal
the launches the wrappers counted while capturing (capture raises
otherwise). :func:`settle` (one read of each step's table, a dropped
step's too, outside the frames) adds each body's runs since the last
settle times its kernel nodes to the launch counters. A step dropped on
the card writes its spans with ``utils/profiling.write_spans``.

On the CPU the same objects run the same bodies directly on the same
static buffers, with no capture, branch on the same predicates read with
``.item()`` and stamp the same table on the host clock: the frame graph's
plain version, on which the tests hold
the copies to the eager ``step.make_step`` and ``step.make_batched_step``
bit for bit. On CUDA there is no other path: a capture or a launch that
fails raises.

The returned state is the live buffers and the returned ``FrameOut`` the
static one: the next frame overwrites both, so a caller that keeps either
across frames clones it.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import re
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import SvoConfig
from ..device import resolve
from ..ops import pyramid
from ..ops import kernels
from ..ops.kernels import _build
from ..utils import profiling
from .state import FrameOut, SlamState, init_state, init_states
from .step import (device_decisions, device_decisions_batched,
                   device_flags, device_flags_batched, make_batched_phases,
                   make_phases)

_COUNTER = {key: counts for counts in kernels.counters() for key in counts}
# the bodies, in capture order: the single step's, then those only the
# batched step has (the bootstrap of some sequences of a booted batch)
GRAPHS = ("P", "flags", "boot", "A_ok", "A_fail", "K", "K_loop", "B")
BATCH_GRAPHS = ("P", "flags", "boot", "A_ok", "A_fail", "K", "K_loop",
                "save", "B", "boot_mix")
# CUgraphNodeType (cuda.h) of the node kinds a capture may record
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
               4: "graph", 5: "empty", 6: "wait_event", 7: "event_record",
               10: "mem_alloc", 11: "mem_free", 13: "conditional"}
# what a conditional body may not hold (CUDA's rules for IF-node bodies)
NOT_IN_A_BODY = ("host", "wait_event", "event_record", "mem_alloc",
                 "mem_free", "other")
# the frames a span table's ring keeps, one row each
RING = 8192
# what a stamp does (csrc/frame_graph.cu: StampOp)
FRAME_START, BODY_START, BODY_END, FRAME_END, CLOCK, COUNT = range(6)
HOST_COLUMNS = ("svo.step.start", "svo.step.end", "svo.step.launch.start",
                "svo.step.launch.end")
_NO_RANGE = contextlib.nullcontext()


def _range(name: str):
    """A profiler range named ``name`` where a profiler is on; else
    nothing (one flag read)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_RANGE


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
    for key, kernel in kernels.KERNELS.items():
        name = kernel.function
        if (f"{len(name)}{name}" in function if function.startswith("_Z")
                else re.search(rf"(?<!\w){name}(?!\w)", function)):
            return key
    return None


def _raw(graph) -> int:
    """The cudaGraph_t of a captured torch graph, or a raw handle."""
    return graph if isinstance(graph, int) else graph.raw_cuda_graph()


def _nodes(graph):
    """(kind, CUDA function name — mangled, as libcuda gives it — or None
    for a node that is no kernel) of every node of a captured graph (a
    torch graph or a raw cudaGraph_t), read from the graph through
    libcuda."""
    drv = ctypes.CDLL("libcuda.so.1")
    ptr = ctypes.c_void_p

    def call(fn, *args):
        err = getattr(drv, fn)(*args)
        if err:
            raise RuntimeError(f"{fn} failed: CUresult {err}")

    raw, n = ptr(_raw(graph)), ctypes.c_size_t(0)
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


def scan(graph) -> Tuple[Dict[str, int], Dict[str, int]]:
    """(nodes by kind — "kernel", "memcpy", "memset", "other" and any
    other kind of ``_NODE_TYPES`` the graph holds — and kernel nodes by
    launch counter) of a captured graph, read from the graph through
    libcuda: each kernel node's function and that function's name."""
    kinds = dict.fromkeys(("kernel", "memcpy", "memset", "other"), 0)
    by_counter = dict.fromkeys(kernels.KERNELS, 0)
    for kind, name in _nodes(graph):
        kinds[kind] = kinds.get(kind, 0) + 1
        key = counter_of(name) if name is not None else None
        if key is not None:
            by_counter[key] += 1
    return kinds, by_counter


def kernel_names(graph) -> Dict[str, int]:
    """A captured graph's kernel nodes by CUDA function name (mangled):
    what two graphs' node counts differ by."""
    out: Dict[str, int] = {}
    for kind, name in _nodes(graph):
        if name is not None:
            out[name] = out.get(name, 0) + 1
    return out


def capture(body: Callable[[], object], pool, stream: torch.cuda.Stream
            ) -> Tuple[torch.cuda.CUDAGraph, object, Dict[str, int]]:
    """Capture ``body()`` on ``stream`` into ``pool``: (the captured
    graph, not instantiated — a frame graph clones it —, what the body
    returned — tensors that launches overwrite — and the launches the
    wrappers counted during capture, which are taken back from the
    counters). A body that synchronises, reads the device or does anything
    else capture refuses raises here."""
    before = _counts()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            out = body()
    finally:
        after = _counts()
        _set_counts(before)
    return graph, out, {k: after[k] - before[k] for k in before}


def _destroy_frame_graph(lib, graph: ctypes.c_void_p,
                         exe: ctypes.c_void_p) -> None:
    if exe.value:
        lib.svo_graph_exec_destroy(exe)
    if graph.value:
        lib.svo_graph_destroy(graph)


class _FrameGraph:
    """``F`` on the card: the ``plan`` of a step — ("run", body) for a
    body every frame runs, ("if", body) for one under its predicate,
    ("set", bodies) for the kernel node that sets those bodies' IF
    handles from their predicates — assembled in that order from the
    bodies' captured graphs (csrc/frame_graph.cu) between the frame's
    start and end stamps, each body between stamps of its own, into the
    span table ``spans``, and instantiated."""

    def __init__(self, plan, graphs: Dict[str, torch.cuda.CUDAGraph],
                 preds: Dict[str, torch.Tensor], spans: "_Spans"):
        lib = _build.load_library()
        self._lib = lib
        self._table = spans.table       # the stamps write it
        self._graph, self._exe = ctypes.c_void_p(), ctypes.c_void_p()
        weakref.finalize(self, _destroy_frame_graph, lib, self._graph,
                         self._exe)

        def check(rc, what):
            if rc:
                raise RuntimeError(
                    f"frame graph: {what} failed (cudaError {rc}); "
                    f"conditional nodes need CUDA 12.4 on the card")

        check(lib.svo_graph_create(ctypes.byref(self._graph)), "creating")
        handles = {}
        for op, arg in plan:
            if op == "if":
                h = ctypes.c_ulonglong()
                check(lib.svo_graph_cond_handle(self._graph,
                                                ctypes.byref(h)),
                      f"the handle of {arg}")
                handles[arg] = h.value
        last = ctypes.c_void_p()
        table = ctypes.c_void_p(self._table.data_ptr())
        n = len(spans.names)

        def stamp(op, body=0):
            check(lib.svo_graph_add_stamp(self._graph, ctypes.byref(last),
                                          table, op, body, n, spans.ring,
                                          spans.counts),
                  f"a stamp ({op}, {body})")

        stamp(FRAME_START)
        for op, arg in plan:
            if op == "run":
                stamp(BODY_START, spans.slot[arg])
                check(lib.svo_graph_add_child(
                    self._graph, ctypes.byref(last),
                    ctypes.c_void_p(graphs[arg].raw_cuda_graph())),
                    f"body {arg}")
                stamp(BODY_END, spans.slot[arg])
            elif op == "if":
                check(lib.svo_graph_add_if(
                    self._graph, ctypes.byref(last), handles[arg],
                    ctypes.c_void_p(graphs[arg].raw_cuda_graph()), table,
                    spans.slot[arg], n, spans.ring, spans.counts),
                    f"the conditional body {arg}")
            else:
                k = len(arg)
                check(lib.svo_graph_add_set(
                    self._graph, ctypes.byref(last),
                    (ctypes.c_ulonglong * k)(*(handles[b] for b in arg)),
                    (ctypes.c_void_p * k)(*(preds[b].data_ptr()
                                            for b in arg)), k),
                    f"the predicates of {arg}")
        stamp(FRAME_END)
        check(lib.svo_graph_instantiate(self._graph,
                                        ctypes.byref(self._exe)),
              "instantiating")

    @property
    def raw(self) -> int:
        """The cudaGraph_t, for :func:`scan`."""
        return self._graph.value

    def launch(self, stream: int) -> None:
        _build.raise_on_error(self._lib.svo_graph_launch(self._exe, stream),
                              "frame graph")


def _capture_graphs(step) -> Tuple[float, int]:
    """Capture every body of ``step`` (a :class:`GraphedStep` or
    :class:`GraphedBatchedStep`) into one pool on one side stream and
    assemble its frame graph: first a warm-up of every body on that stream
    (lazy state, cuSOLVER's and cuBLAS's handles, the first ``jacfwd``'s
    set-up), then the captures in
    ``graph_names`` order, each body's kernel nodes held to what its
    capture counted and its node kinds to what a conditional body may
    hold, then ``F``. Capture synchronises, so it happens here and never
    inside a frame. The warm-up writes into the live state, which is reset
    at the end. Returns (seconds, bytes the pool holds)."""
    t0 = time.perf_counter()
    dev = step.device
    with torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        saved = _counts()
        with torch.cuda.stream(side):
            for name in step.graph_names:
                step._run_body(name)
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
            # a body captured before it used for temporaries, that body
            # would overwrite it
            for name in step.graph_names:
                graph, _, counted = capture(
                    lambda: step._body(name), pool, side)
                step.nodes[name], step.kernel_nodes[name] = scan(graph)
                if step.kernel_nodes[name] != counted:
                    raise RuntimeError(
                        f"graph {name} holds the kernel nodes "
                        f"{step.kernel_nodes[name]}, but its capture "
                        f"counted the launches {counted}")
                barred = {k: n for k, n in step.nodes[name].items()
                          if k in NOT_IN_A_BODY and n}
                if barred:
                    raise RuntimeError(
                        f"graph {name} holds {barred}: a conditional body "
                        f"may hold only kernel, memset, memcpy, empty, "
                        f"child-graph and conditional nodes")
                step.graphs[name] = graph
        finally:
            if collecting:
                gc.enable()
        step._frame = _FrameGraph(step._plan, step.graphs,
                                  step._pred_views, step._spans)
        step.nodes["F"], _ = scan(step._frame.raw)
        torch.cuda.synchronize(dev)
        pool_bytes = torch.cuda.memory_reserved(dev) - base
        step.reset()
        torch.cuda.synchronize(dev)
    CAPTURES["steps"] += 1
    return time.perf_counter() - t0, pool_bytes


def stages_of(cfg: SvoConfig) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(stages, counters) a single step of ``cfg`` keeps: the epipolar
    search (``svo.stage.epi``, ``svo.count.epi_recovered``) where
    ``epi_samples > 0``, window BA (``svo.stage.ba``,
    ``svo.count.ba_keyframes``) where ``use_ba``."""
    kept = [(stage, counter) for stage, counter, on in (
        ("epi", "epi_recovered", cfg.epi_samples > 0),
        ("ba", "ba_keyframes", cfg.use_ba)) if on]
    return (tuple(g for g, _ in kept), tuple(c for _, c in kept))


class _Spans:
    """A step's span table, its host ring, each body's kernel nodes and the
    runs already added to the launch counters. It outlives its step until
    :func:`settle` has added its last runs.

    The table (int64, on the step's device; its layout is
    csrc/frame_graph.cu's): a slot for each body and then each stage, with
    its runs and summed nanoseconds, the frame counter, and a ring of
    :data:`RING` rows, the frame's row at the counter modulo the ring — the
    frame's start and end, each slot's nanoseconds in it and its start
    after the frame's (0 where it did not run), then each counter's value
    (0 where none was written). On the card the frame graph's stamp nodes
    write it on the device's clock, ``%globaltimer``, calibrated against
    the host's (``time.perf_counter_ns``) when the table is made, a stage's
    and a counter's stamps being kernel nodes of its body's graph; on the
    CPU :meth:`stamp` writes it on the host's. The host ring: the start and
    end of the step's call and of its launch of the frame
    (:data:`HOST_COLUMNS`), a row a launch. ``stages`` and ``counters``
    are what ``utils/profiling.stage`` and ``count`` write to while the
    step captures or plainly runs a body (:meth:`open`, :meth:`close`,
    :meth:`count`)."""

    def __init__(self, names: Tuple[str, ...], device: torch.device,
                 kind: str, batch: int, stages: Tuple[str, ...] = (),
                 counters: Tuple[str, ...] = ()):
        self.bodies, self.kind, self.batch = names, kind, batch
        self.stages, self.counters = stages, counters
        self.names = names + tuple(f"stage.{g}" for g in stages)  # slots
        n = len(self.names)
        self.counts = len(counters)
        self.slot = {g: i for i, g in enumerate(self.names)}
        self.ring = RING
        self.head = 3 * n + 2
        self.width = 2 + 2 * n + self.counts
        self.table = torch.zeros(self.head + self.ring * self.width,
                                 dtype=torch.int64, device=device)
        self.host = np.zeros((self.ring, len(HOST_COLUMNS)), np.int64)
        self.launches = 0
        self.settled = [0] * n
        self.kernel_nodes: Dict[str, Dict[str, int]] = {}
        self.step_alive = True
        self._final: Optional[List[int]] = None    # runs, once released
        self.device_minus_host_ns = 0
        self.realtime_minus_host_ns = time.time_ns() - time.perf_counter_ns()
        self.calibration_ns = 0
        self._plain = None              # the CPU's views of the table
        if device.type == "cuda":
            self._calibrate()
        else:
            t = self.table.numpy()
            self._plain = (t[:n], t[n:2 * n], t[2 * n:2 * n + 1],
                           t[2 * n + 2:self.head],
                           t[self.head:].reshape(self.ring, self.width))

    def _calibrate(self, tries: int = 5) -> None:
        """The device clock against the host's: a stamp between two host
        reads, each after a synchronisation; of ``tries``, the one whose
        reads lie closest together, its stamp set at their midpoint."""
        lib, dev = _build.load_library(), self.table.device
        n, best = len(self.names), None
        for _ in range(tries):
            torch.cuda.synchronize(dev)
            h0 = time.perf_counter_ns()
            _build.raise_on_error(
                lib.svo_stamp(self.table.data_ptr(), CLOCK, 0, n, self.ring,
                              self.counts, None, _build.stream(dev)),
                "stamp")
            torch.cuda.synchronize(dev)
            h1 = time.perf_counter_ns()
            if best is None or h1 - h0 < best[0]:
                best = (h1 - h0, int(self.table[2 * n + 1]) - (h0 + h1) // 2)
        self.calibration_ns, self.device_minus_host_ns = best

    def stamp(self, op: int, body: int = 0, value: int = 0) -> None:
        """The plain version of a stamp node, on the host clock (a COUNT
        stamp writes ``value``)."""
        now = time.perf_counter_ns()
        runs, ns, frames, start, ring = self._plain
        row = ring[frames[0] % self.ring]
        if op == FRAME_START:
            row[:] = 0
            row[0] = now
        elif op == BODY_START:
            start[body] = now
        elif op == BODY_END:
            d = now - start[body]
            runs[body] += 1
            ns[body] += d
            row[2 + body] = d
            row[2 + len(self.names) + body] = start[body] - row[0]
        elif op == COUNT:
            row[2 + 2 * len(self.names) + body] = value
        else:
            row[1] = now
            frames[0] += 1

    def _inside(self, op: int, body: int,
                value: Optional[torch.Tensor] = None) -> None:
        """A stamp from inside a body: on the card launched on the current
        stream (in a capture, a kernel node of the body being captured),
        on the CPU the plain version's. A COUNT stamp writes ``value``, a
        0-dim integer tensor."""
        if self._plain is not None:
            self.stamp(op, body, 0 if value is None else int(value))
            return
        src = None if value is None else value.to(torch.int32).reshape(())
        _build.raise_on_error(_build.load_library().svo_stamp(
            self.table.data_ptr(), op, body, len(self.names), self.ring,
            self.counts, None if src is None else src.data_ptr(),
            _build.stream(self.table.device)), "stamp")

    def open(self, stage: str) -> None:
        """The entry stamp of stage ``stage``."""
        self._inside(BODY_START, self.slot[f"stage.{stage}"])

    def close(self, stage: str) -> None:
        """The exit stamp of stage ``stage``."""
        self._inside(BODY_END, self.slot[f"stage.{stage}"])

    def count(self, counter: str, value: torch.Tensor) -> None:
        """The frame's value of ``counter``: a 0-dim integer tensor."""
        self._inside(COUNT, self.counters.index(counter), value)

    def host_span(self, *times: int) -> None:
        """The host clock's readings of :data:`HOST_COLUMNS` for this
        launch."""
        self.host[self.launches % self.ring] = times
        self.launches += 1

    def runs(self) -> List[int]:
        """Each slot's runs (one read of the device)."""
        if self.table is None:
            return self._final
        return self.table[:len(self.names)].tolist()

    def record(self) -> dict:
        """The spans as one JSON-ready object (one read of the device): the
        step's kind and batch, the bodies, runs and nanoseconds by body,
        the filled rows of the device ring (its stage and counter columns
        too) and of the host ring, oldest first, and the clocks'
        offsets."""
        n, b = len(self.names), len(self.bodies)
        t = self.table.cpu().numpy()
        frames = int(t[2 * n])

        def filled(ring, count):
            return np.roll(ring, -(count % self.ring),
                           axis=0)[self.ring - min(count, self.ring):]

        ring = t[self.head:].reshape(self.ring, self.width)
        slots = [f"svo.body.{g}" for g in self.bodies] + [
            f"svo.stage.{g}" for g in self.stages]
        return {
            "kind": self.kind, "batch": self.batch,
            "bodies": list(self.bodies),
            "runs": dict(zip(self.bodies, t[:b].tolist())),
            "ns": dict(zip(self.bodies, t[n:n + b].tolist())),
            "frames": frames, "launches": self.launches, "ring": self.ring,
            "device_columns": ["svo.frame.start", "svo.frame.end",
                               *(f"{g}.ns" for g in slots),
                               *(f"{g}.at" for g in slots),
                               *(f"svo.count.{c}" for c in self.counters)],
            "device_rows": filled(ring, frames).tolist(),
            "host_columns": list(HOST_COLUMNS),
            "host_rows": filled(self.host, self.launches).tolist(),
            "clock": {"host": "time.perf_counter_ns",
                      "device_minus_host_ns": self.device_minus_host_ns,
                      "realtime_minus_host_ns": self.realtime_minus_host_ns,
                      "calibration_ns": self.calibration_ns}}

    def release(self) -> None:
        """Keep the runs alone (the step is gone)."""
        self._final = self.runs()
        self.table = self.host = self._plain = None

    def settle(self) -> None:
        """Add the runs since the last settle, times each body's kernel
        nodes, to the launch counters (one read)."""
        runs = self.runs()
        for name, now, then in zip(self.names, runs, self.settled):
            for key, n in self.kernel_nodes.get(name, {}).items():
                _COUNTER[key][key] += (now - then) * n
        self.settled[:] = runs


def _dropped(spans: _Spans) -> None:
    """A step is gone (its finalizer)."""
    spans.step_alive = False
    _release_dropped()


def _release_dropped() -> None:
    """The tables of the steps dropped since: on the card their spans are
    written out (``profiling.write_spans``); the table and the rings go,
    the runs stay until :func:`settle`. Not while a graph is captured or a
    ``torch.func`` transform runs (a finalizer can run inside either): the
    next call does it, from the next drop, :func:`settle` or step made."""
    if torch._C._are_functorch_transforms_active() or (
            torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        return
    for spans in _SPANS:
        if not spans.step_alive and spans.table is not None:
            if spans.table.is_cuda:
                profiling.write_spans(spans.record)
            spans.release()


# the span tables of the steps made, until settle() has added the last
# runs of a step that is gone
_SPANS: List[_Spans] = []
# steps (single or batched) whose bodies were captured in this process:
# how bench_torch.py shows that a path captures its step once
CAPTURES = {"steps": 0}


def settle() -> None:
    """Add every step's body runs since the last settle, times each
    body's kernel nodes, to the launch counters: one read of each step's
    table (the steps dropped since included). Call it outside the
    frames, before the counters are set or read."""
    _release_dropped()
    for spans in list(_SPANS):
        spans.settle()
        if not spans.step_alive:
            _SPANS.remove(spans)


def live_spans() -> List[_Spans]:
    """The span tables of the steps alive in this process."""
    return [s for s in _SPANS if s.step_alive]


class _FrameStep:
    """What the single and the batched step share: the static buffers,
    the span table, the frame graph and its plain version, the call. A
    subclass sets ``_preds`` (a predicate slot per conditional body),
    ``_plan`` and ``graph_names`` and defines ``_run_body(name)`` (run
    body ``name``; dispatched by name: bodies bound to the step and kept
    on it would make a reference cycle, and a step freed by the cyclic
    collector during another step's capture would destroy its graphs
    there, which invalidates that capture)."""

    _preds: Tuple[str, ...] = ()

    def _setup(self, cfg: SvoConfig, device, state: SlamState, hw,
               graph_names, plan, batch: Optional[int],
               stages: Tuple[Tuple[str, ...], Tuple[str, ...]] = ((), ())
               ) -> None:
        """``batch``: the batched step's B, None for the single step;
        ``stages``: the (stages, counters) its span table keeps."""
        self.cfg = cfg
        self.device = resolve(device)
        self.state: SlamState = state                       # S, live
        self._s = _leaves(self.state)
        self._s1 = [torch.empty_like(x) for x in self._s]   # S', staged
        self._ctx: Optional[List[torch.Tensor]] = None
        self._ctx_like = None
        self._out: Optional[FrameOut] = None
        self._img_l = torch.zeros(hw, dtype=torch.float32, device=self.device)
        self._img_r = torch.zeros_like(self._img_l)
        self._pyr = None
        self.graph_names = tuple(graph_names)
        # the plan names only the bodies this configuration has
        self._plan = []
        for op, arg in plan:
            if op == "set":
                arg = tuple(b for b in arg if b in self.graph_names)
            elif arg not in self.graph_names:
                continue
            self._plan.append((op, arg))
        self._pred = torch.zeros(len(self._preds), dtype=torch.bool,
                                 device=self.device)
        self._pred_views = {b: self._pred[i]
                            for i, b in enumerate(self._preds)}
        self._spans = _Spans(self.graph_names, self.device,
                             "single" if batch is None else "batched",
                             batch or 1, *stages)
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self.nodes: Dict[str, Dict[str, int]] = {}         # scan(), by kind
        self.kernel_nodes = self._spans.kernel_nodes       # by counter
        self._frame: Optional[_FrameGraph] = None
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        if self.device.type == "cuda":
            self.capture_seconds, self.pool_bytes = _capture_graphs(self)
        _release_dropped()
        _SPANS.append(self._spans)
        weakref.finalize(self, _dropped, self._spans)

    # --- the bodies ---

    def _body(self, name: str) -> None:
        """Run body ``name`` with the stage stamps and counters it holds
        (``utils/profiling.stage``, ``count``) going to the span table:
        in a capture, where they become kernel nodes of the body, and in
        the plain version; the warm-up before the captures runs
        ``_run_body`` alone."""
        with profiling.stages(self._spans):
            self._run_body(name)

    def _set_preds(self, **values: torch.Tensor) -> None:
        """Write 0-dim bool tensors into the predicates of the bodies
        named, one copy each."""
        for name, v in values.items():
            self._pred_views[name].copy_(v)

    def _write_ctx(self, ctx) -> None:
        if self._ctx is None:
            self._ctx_like = ctx
            self._ctx = [torch.empty_like(x) for x in _leaves(ctx)]
        _copy_into(self._ctx, ctx)

    def _write_out(self, out: FrameOut) -> None:
        if self._out is None:
            self._out = FrameOut(*(torch.empty_like(x) for x in out))
        _copy_into(list(self._out), out)

    def _staged(self) -> SlamState:
        """S' as a SlamState."""
        return _tree(self.state, iter(self._s1))

    @property
    def context(self):
        """The static TrackCtx of the last track body."""
        return _tree(self._ctx_like, iter(self._ctx))

    # --- the frame ---

    def _frame_plain(self) -> None:
        """The frame graph's plain version: the plan's bodies run directly,
        each conditional one where its predicate, read from the device,
        holds, stamped as ``F``'s stamp nodes stamp them."""
        spans = self._spans
        spans.stamp(FRAME_START)
        for op, arg in self._plan:
            if op == "run" or (op == "if" and self._pred_views[arg].item()):
                spans.stamp(BODY_START, spans.slot[arg])
                self._body(arg)
                spans.stamp(BODY_END, spans.slot[arg])
        spans.stamp(FRAME_END)

    def __call__(self, state: SlamState, img_l: torch.Tensor,
                 img_r: torch.Tensor) -> Tuple[SlamState, FrameOut]:
        """``state`` into the live buffers (unless it is them), the images
        into the static ones, then one frame: one launch of ``F`` (CPU:
        its plain version). Host spans ``svo.step`` (the call) and
        ``svo.step.launch`` (the launch)."""
        t0 = time.perf_counter_ns()
        with _range("svo.step"):
            if state is not self.state:
                self.load(state)
            for buf, img in ((self._img_l, img_l), (self._img_r, img_r)):
                if tuple(img.shape) != tuple(buf.shape):
                    raise ValueError(f"image {tuple(img.shape)}: the step "
                                     f"was made for {tuple(buf.shape)}")
                buf.copy_(img)
            t1 = time.perf_counter_ns()
            with _range("svo.step.launch"):
                if self._frame is None:
                    self._frame_plain()
                else:
                    self._frame.launch(_build.stream(self._img_l.device))
            t2 = time.perf_counter_ns()
        self._spans.host_span(t0, time.perf_counter_ns(), t1, t2)
        return self.state, self._out

    def load(self, state: SlamState) -> None:
        """Copy ``state`` into the live buffers (fields that are those
        buffers already are skipped)."""
        _copy_into(self._s, state)

    # --- the body counters ---

    @property
    def replays(self) -> Dict[str, int]:
        """Runs of each body since the step was made ("P" and "flags": the
        frames), read from the span table (one read)."""
        runs = dict(zip(self._spans.names, self._spans.runs()))
        return {g: runs.get(g, 0) for g in BATCH_GRAPHS}

    def spans(self) -> dict:
        """The step's spans as :meth:`_Spans.record` gives them (one read),
        what a dropped step on the card writes out."""
        return self._spans.record()


class GraphedStep(_FrameStep):
    """``step(state, img_l, img_r) -> (state, FrameOut)``, the reference's
    jitted step, on static buffers (module docstring): one launch of the
    frame graph a frame, the bootstrap included, and no host read. Images
    are (H,W) at the configuration's camera size."""

    _preds = ("boot", "A_ok", "A_fail", "K", "K_loop", "B")

    def __init__(self, cfg: SvoConfig, device="cuda"):
        self._boot, self._track, self._kf, self._post = make_phases(cfg)
        dev = resolve(device)
        self._setup(
            cfg, dev, init_state(cfg, dev),
            (cfg.camera.height, cfg.camera.width),
            (g for g in GRAPHS if g != "K_loop"
             or cfg.online_loop_every > 0),
            [("run", "P"), ("run", "flags"),
             ("set", ("boot", "A_ok", "A_fail", "B")),
             ("if", "boot"), ("if", "A_ok"), ("if", "A_fail"),
             ("set", ("K", "K_loop")), ("if", "K"), ("if", "K_loop"),
             ("if", "B")], None, stages_of(cfg))

    def _run_body(self, name: str) -> None:
        if name == "P":
            # captured, its outputs are the static pyramid
            self._pyr = pyramid.build_with_gradients(self._img_l,
                                                     self.cfg.num_levels)
        elif name == "flags":
            booted, prev_ok = device_flags(self.state)
            no = torch.zeros_like(booted)
            self._pred.copy_(torch.stack([~booted, booted & prev_ok,
                                          booted & ~prev_ok, no, no,
                                          booted]))
        elif name == "boot":
            st, out = self._boot(self.state, *self._pyr, self._img_r)
            _copy_into(self._s, st)
            self._write_out(out)
        elif name in ("A_ok", "A_fail"):
            st, ctx = self._track(self.state, *self._pyr, self._img_r,
                                  prev_ok=name == "A_ok")
            _copy_into(self._s1, st)
            self._write_ctx(ctx)
            need_kf, _, run_loop = device_decisions(self.cfg, st, ctx)
            self._set_preds(K=need_kf & ~run_loop, K_loop=run_loop)
        elif name in ("K", "K_loop"):
            # reads S' and writes it: _copy_into clones what lies in it
            _copy_into(self._s1, self._kf(self._staged(), *self._pyr,
                                          self._img_r, self.context.T_cw,
                                          name == "K_loop"))
        else:
            st, out = self._post(self._staged(), *self._pyr, self.context)
            _copy_into(self._s, st)
            self._write_out(out)

    def reset(self) -> None:
        """Copy the initial state into the live buffers."""
        self.load(init_state(self.cfg, self.device))


class GraphedBatchedStep(_FrameStep):
    """``bstep(states, img_l, img_r) -> (states, outs)``, the reference's
    jitted batched step (a stacked state and FrameOut, every field with a
    leading B axis, (B,H,W) images), on one stacked set of static buffers:
    one launch of the frame graph a batched frame, with no host read.

    Its bodies are those of :class:`GraphedStep`, each captured once over
    the whole batch from ``step.make_batched_phases``, every phase
    ``torch.func.vmap``ped over the stacked state, so every kernel node
    takes the B sequences as its problem axis and a body holds about the
    single step's nodes, not B times them. Their predicates are the
    reference's batch-level conds: ``boot`` when no sequence has a
    keyframe; ``A_fail`` when a booted sequence failed last frame (the
    rotated variants count where a sequence's own state failed), else
    ``A_ok``, when any is booted; ``K`` when a booted sequence needs a
    keyframe and ``K_loop`` when the online loop is due in one; ``B`` when
    any is booted. A batch that mixes booted and unbooted sequences also
    runs ``save`` (a copy of ``S`` before ``B``) and ``boot_mix`` (the
    bootstrap from that copy, kept where a sequence has no keyframe);
    ``where`` keeps each sequence's own result, as the eager batched step
    does. The returned state is the live buffers and the FrameOut the
    static one: the next batched frame overwrites both."""

    _preds = ("boot", "A_ok", "A_fail", "K", "K_loop", "save", "B",
              "boot_mix")

    def __init__(self, cfg: SvoConfig, B: int, device="cuda"):
        self.B = B
        self._phases = make_batched_phases(cfg)
        dev = resolve(device)
        state = init_states(cfg, B, dev)
        self._before = [torch.empty_like(x) for x in _leaves(state)]
        self._booted = torch.zeros(B, dtype=torch.bool, device=dev)
        self._setup(
            cfg, dev, state, (B, cfg.camera.height, cfg.camera.width),
            (g for g in BATCH_GRAPHS if g != "K_loop"
             or cfg.online_loop_every > 0),
            [("run", "P"), ("run", "flags"),
             ("set", ("boot", "A_ok", "A_fail", "save", "B", "boot_mix")),
             ("if", "boot"), ("if", "A_ok"), ("if", "A_fail"),
             ("set", ("K", "K_loop")), ("if", "K"), ("if", "K_loop"),
             ("if", "save"), ("if", "B"), ("if", "boot_mix")], B)

    def _run_body(self, name: str) -> None:
        ph = self._phases
        if name == "P":
            self._pyr = ph.pyramid(self._img_l)
        elif name == "flags":
            booted, _, any_boot, any_failed = device_flags_batched(
                self.state)
            self._booted.copy_(booted)
            any_b = booted.any()
            mixed = any_b & any_boot
            no = torch.zeros_like(any_b)
            self._pred.copy_(torch.stack([~any_b, any_b & ~any_failed,
                                          any_failed, no, no, mixed, any_b,
                                          mixed]))
        elif name == "boot":
            st, out = ph.boot(self.state, self._pyr, self._img_r)
            _copy_into(self._s, st)
            self._write_out(out)
        elif name in ("A_ok", "A_fail"):
            st, ctx = ph.track(self.state, self._pyr, self._img_r,
                               any_failed=name == "A_fail")
            _copy_into(self._s1, st)
            self._write_ctx(ctx)
            *_, any_kf, any_loop = device_decisions_batched(
                self.cfg, st, ctx, self._booted)
            self._set_preds(K=any_kf & ~any_loop, K_loop=any_loop)
        elif name in ("K", "K_loop"):
            _copy_into(self._s1, ph.kf(self._staged(), self._pyr,
                                       self._img_r, self.context,
                                       run_loop=name == "K_loop"))
        elif name == "save":
            _copy_into(self._before, self.state)
        elif name == "B":
            st, out = ph.post(self._staged(), self._pyr, self.context)
            _copy_into(self._s, st)
            self._write_out(out)
        else:
            # the bootstrap reads S as it was before B
            before = _tree(self.state, iter(self._before))
            st, out = ph.boot(before, self._pyr, self._img_r,
                              (self.state, self._out))
            _copy_into(self._s, st)
            self._write_out(out)

    def reset(self) -> None:
        """Copy the initial states into the live buffers."""
        self.load(init_states(self.cfg, self.B, self.device))


def make_graphed_step(cfg: SvoConfig, device="cuda") -> GraphedStep:
    """The per-frame step on static buffers, captured as one frame graph
    with device-side branches on a CUDA device (its plain version on the
    CPU): ``step(state, img_l, img_r) -> (state, FrameOut)``. The returned
    state is ``step.state``, the live buffers; a ``state`` argument that
    is not those is copied into them first."""
    return GraphedStep(cfg, device)


def make_graphed_batched_step(cfg: SvoConfig, B: int, device="cuda"
                              ) -> GraphedBatchedStep:
    """The counterpart of ``step.make_batched_step`` on one stacked set of
    static buffers, its bodies captured once for the whole batch into one
    frame graph: ``bstep(states, img_l, img_r) -> (states, outs)`` with no
    host read."""
    return GraphedBatchedStep(cfg, B, device)


__all__ = ["make_graphed_step", "make_graphed_batched_step", "GraphedStep",
           "GraphedBatchedStep", "capture", "scan", "kernel_names",
           "counter_of", "settle", "live_spans", "stages_of", "GRAPHS",
           "BATCH_GRAPHS", "NOT_IN_A_BODY", "CAPTURES", "RING"]
