"""Flowgraph: wire blocks into a DAG, compile to ONE jitted step.

The reference's hot loop pays two PCIe DMAs per block per call
(SURVEY §3.2); here the whole chain is a single XLA program over
HBM-resident frames — blocks exchange data through fusion, not DMA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from clenabled_tpu.streaming.block import Block


@dataclasses.dataclass(frozen=True)
class _Edge:
    src: Block
    src_port: int
    dst: Block
    dst_port: int


class Flowgraph:
    """Build with connect(); compile(frame_size) returns a Runner.

    ``frame_size`` is the samples-per-step at rate-1.0 edges driven by
    external inputs; source blocks declare their own ``source_frame``.
    """

    def __init__(self):
        self._blocks: list[Block] = []
        self._edges: list[_Edge] = []
        self._external: list[tuple[Block, int]] = []  # host-fed inputs
        self._taps: list[tuple[Block, int, str]] = []  # exposed outputs

    def add(self, block: Block) -> Block:
        if block not in self._blocks:
            self._blocks.append(block)
        return block

    def connect(self, src: Block, dst: Block, src_port: int = 0,
                dst_port: int = 0) -> None:
        self.add(src)
        self.add(dst)
        if src_port >= src.n_outputs:
            raise ValueError(f"{src} has no output port {src_port}")
        if dst_port >= dst.n_inputs:
            raise ValueError(f"{dst} has no input port {dst_port}")
        for e in self._edges:
            if e.dst is dst and e.dst_port == dst_port:
                raise ValueError(f"{dst} input {dst_port} already connected")
        self._edges.append(_Edge(src, src_port, dst, dst_port))

    def external_input(self, dst: Block, dst_port: int = 0) -> int:
        """Declare a host-fed stream into ``dst``; returns the feed index
        used in Runner.step(feeds)."""
        self.add(dst)
        self._external.append((dst, dst_port))
        return len(self._external) - 1

    def tap(self, src: Block, src_port: int = 0, name: str | None = None) -> str:
        """Expose a stream output from the step (sink analogue)."""
        self.add(src)
        name = name or f"{src.name or type(src).__name__}_{len(self._taps)}"
        self._taps.append((src, src_port, name))
        return name

    # ---- compilation ----

    def _toposort(self) -> list[Block]:
        incoming: dict[int, int] = {id(b): 0 for b in self._blocks}
        for e in self._edges:
            incoming[id(e.dst)] += 1
        ready = [b for b in self._blocks if incoming[id(b)] == 0]
        order: list[Block] = []
        while ready:
            b = ready.pop()
            order.append(b)
            for e in self._edges:
                if e.src is b:
                    incoming[id(e.dst)] -= 1
                    if incoming[id(e.dst)] == 0:
                        ready.append(e.dst)
        if len(order) != len(self._blocks):
            raise ValueError("flowgraph has a cycle")
        return order

    def compile(self, frame_size: int | None = 8192,
                precision: str | None = None,
                steps_per_dispatch: int | str = "auto",
                vectorize: bool = True) -> "Runner":
        """Build the Runner.  precision: matmul precision for the whole
        jitted step ("float32" = exact f32 sums; None = the backend
        default, which on a GPU may run f32 matmuls in TF32 — see
        clenabled_tpu.exact_f32).

        steps_per_dispatch: run K frames per device dispatch via a
        device-side lax.scan over the step closure.  At the reference's
        default frame sizes (8192-sample GR buffers) a per-frame host
        dispatch costs more than the device compute — K amortizes it
        without changing per-frame semantics (states thread through the
        scan exactly as through K separate step() calls; outputs and
        messages gain a leading K axis).  Runner.run() accepts per-frame
        feed iterators regardless and batches them host-side.

        ``steps_per_dispatch="auto"`` (the default) picks K so each
        dispatch carries ~2^21 base-frame samples (clamped to [1, 64]);
        these constants are not yet measured on the GPU (ROADMAP S7).
        In auto mode ``Runner.step`` keeps exact
        per-frame semantics for per-frame feeds (single-frame jit) and
        uses the scanned dispatch only for stacked [K, ...] feeds or via
        ``Runner.run`` — so defaulting to the fast path changes no
        call-site behavior.  Pass an explicit int to pin K (step() then
        REQUIRES stacked feeds)."""
        order, step, frames, resolved = self._build(frame_size)
        auto = steps_per_dispatch == "auto"
        if auto:
            if (vectorize and self._external
                    and all(getattr(b, "stateless", False) for b in order)):
                # all-stateless graphs dispatch through ONE vmapped XLA
                # program (no scan sequentialization), which keeps scaling
                # past the scan path's sweet spot — target 2^22 samples
                # per dispatch
                steps_per_dispatch = max(1, min(512,
                                                (1 << 22) // max(1, resolved)))
            else:
                steps_per_dispatch = max(1, min(64,
                                                (1 << 21) // max(1, resolved)))
        return Runner(self, order, step, frames, resolved,
                      precision=precision,
                      steps_per_dispatch=steps_per_dispatch,
                      auto_dispatch=auto, vectorize=vectorize)

    def _resolve_frame_size(self, order, in_edges, ext_ports,
                            frame_size: int | None) -> int:
        """Static multi-rate solver (GR's forecast contract, resolved at
        compile time instead of via inter-block runtime buffering).

        Every externally-fed stream length is B·r for the unknown base
        frame B (r = the rational product of block rates along the path).
        Each block contributes constraints: B·r must be an integer and a
        multiple of its quantum.  The minimal valid B is the lcm of the
        per-constraint minima; ``frame_size=None`` picks it, an explicit
        frame_size is validated against it.  Mismatched quanta between
        producers and consumers therefore never need dynamic buffering —
        the whole graph steps at a common super-frame."""
        import math
        from fractions import Fraction

        scale: dict[tuple[int, int], Fraction] = {}   # B-multiplier per port
        fixed: dict[tuple[int, int], int] = {}        # source-driven ports
        b_min = 1          # B must be a multiple of this
        b_eq: int | None = None   # B pinned by a fixed/scaled meeting point

        def need_multiple(k: int):
            nonlocal b_min
            b_min = math.lcm(b_min, max(1, k))

        for b in order:
            if b.n_inputs == 0:
                out = b.out_frame(0)
                for p in range(b.n_outputs):
                    fixed[(id(b), p)] = out
                continue
            vals = []
            for p in range(b.n_inputs):
                if (id(b), p) in ext_ports:
                    vals.append(("scaled", Fraction(1)))
                elif p in in_edges[id(b)]:
                    e = in_edges[id(b)][p]
                    key = (id(e.src), e.src_port)
                    if key in fixed:
                        vals.append(("fixed", fixed[key]))
                    else:
                        vals.append(("scaled", scale[key]))
                else:
                    raise ValueError(f"{b} input {p} unconnected")
            kinds = {k for k, _ in vals}
            if kinds == {"fixed"}:
                sizes = {v for _, v in vals}
                if len(sizes) != 1:
                    raise ValueError(f"{b} input frames disagree: {sizes}")
                out = b.out_frame(sizes.pop())
                for p in range(b.n_outputs):
                    fixed[(id(b), p)] = out
                continue
            rs = {v for k, v in vals if k == "scaled"}
            if len(rs) != 1:
                raise ValueError(
                    f"{b} input rates disagree: {sorted(rs)} — resample "
                    f"one branch so both arrive at the same rate")
            r = rs.pop()
            if "fixed" in kinds:
                f_sizes = {v for k, v in vals if k == "fixed"}
                if len(f_sizes) != 1:
                    raise ValueError(f"{b} input frames disagree: {f_sizes}")
                pin = Fraction(f_sizes.pop()) / r
                if pin.denominator != 1:
                    raise ValueError(
                        f"{b}: fixed-size input cannot align with the "
                        f"rate-{r} external path")
                if b_eq is not None and b_eq != int(pin):
                    raise ValueError(
                        f"conflicting base frame sizes: {b_eq} vs {int(pin)}")
                b_eq = int(pin)
            # constraints: B·r integral and a multiple of b.quantum, i.e.
            # B a multiple of quantum·rd/gcd(rn, quantum·rd)
            rn, rd = r.numerator, r.denominator
            need_multiple(b.quantum * rd // math.gcd(rn, b.quantum * rd))
            r_out = r * b.rate
            need_multiple(r_out.denominator)   # outputs must be integral
            for p in range(b.n_outputs):
                scale[(id(b), p)] = r_out

        if b_eq is not None:
            if b_eq <= 0 or b_eq % b_min:
                raise ValueError(
                    f"source-pinned base frame {b_eq} violates the rate "
                    f"constraints (must be a positive multiple of {b_min})")
            b_min = b_eq
        if frame_size is None:
            return b_min
        if b_eq is not None and frame_size != b_eq:
            raise ValueError(
                f"frame_size={frame_size} conflicts with the source-pinned "
                f"base frame {b_eq}")
        if frame_size % b_min:
            raise ValueError(
                f"frame_size={frame_size} must be a multiple of {b_min} "
                f"(rate/quantum constraints; pass frame_size=None for the "
                f"minimal valid size)")
        return frame_size

    def _build(self, frame_size: int | None):
        """Topo-sort, propagate frame sizes, and build the (unjitted) step
        closure.  Called by compile() and again by Runner.refresh() after a
        live block reconfiguration (set_taps) — the closure reads each
        block's current apply, so a rebuild picks up new taps/kernels."""
        order = self._toposort()
        in_edges: dict[int, dict[int, _Edge]] = {id(b): {} for b in self._blocks}
        for e in self._edges:
            in_edges[id(e.dst)][e.dst_port] = e
        ext_ports = {(id(b), p): i for i, (b, p) in enumerate(self._external)}

        frame_size = self._resolve_frame_size(order, in_edges, ext_ports,
                                              frame_size)

        # frame-size propagation (GR's forecast, statically resolved)
        frames: dict[tuple[int, int], int] = {}
        for b in order:
            if b.n_inputs == 0:
                out = b.out_frame(0)
            else:
                sizes = []
                for p in range(b.n_inputs):
                    if (id(b), p) in ext_ports:
                        sizes.append(frame_size)
                    elif p in in_edges[id(b)]:
                        e = in_edges[id(b)][p]
                        sizes.append(frames[(id(e.src), e.src_port)])
                    else:
                        raise ValueError(f"{b} input {p} unconnected")
                if len(set(sizes)) != 1:
                    raise ValueError(f"{b} input frames disagree: {sizes}")
                out = b.out_frame(sizes[0])
            for p in range(b.n_outputs):
                frames[(id(b), p)] = out

        taps = list(self._taps)

        def step(states: tuple, feeds: tuple):
            values: dict[tuple[int, int], Any] = {}
            new_states = list(states)
            messages: dict[str, Any] = {}
            for i, b in enumerate(order):
                ins = []
                for p in range(b.n_inputs):
                    if (id(b), p) in ext_ports:
                        ins.append(feeds[ext_ports[(id(b), p)]])
                    else:
                        e = in_edges[id(b)][p]
                        ins.append(values[(id(e.src), e.src_port)])
                if b.debug:
                    # trace-time capture for Runner.lowered_text /
                    # the one-time HLO dump (reference: setDebug prints
                    # the generated kernel source at build time)
                    b._debug_avals = (_avals(states[i]), _avals(ins))
                st, outs, msgs = b.apply(states[i], ins)
                new_states[i] = st
                for p, v in enumerate(outs):
                    values[(id(b), p)] = v
                for k, v in msgs.items():
                    messages[f"{b.name or type(b).__name__}.{k}"] = v
            tapped = {name: values[(id(s), p)] for s, p, name in taps}
            return tuple(new_states), tapped, messages

        return order, step, frames, frame_size


def _avals(tree):
    """Shape/dtype skeleton of a pytree (works on tracers — used at trace
    time to capture a debug block's exact input signature)."""
    return jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(jnp.shape(x), jnp.asarray(x).dtype
                                       if not hasattr(x, "dtype") else x.dtype),
        tree)


class Runner:
    """Owns device state, drives the jitted step, dispatches messages."""

    def __init__(self, graph: Flowgraph, order: Sequence[Block],
                 step_fn: Callable, frames: dict, frame_size: int,
                 precision: str | None = None, steps_per_dispatch: int = 1,
                 auto_dispatch: bool = False, vectorize: bool = True):
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        self._graph = graph
        self._order = list(order)
        self._precision = precision
        self.steps_per_dispatch = steps_per_dispatch
        self.auto_dispatch = auto_dispatch
        # vectorize=False forces the lax.scan dispatch even for all-
        # stateless graphs (A/B + debugging surface; semantics identical)
        self.vectorize = vectorize
        # donate the carried state: accumulators and tails update in place
        # (the Runner owns the only reference and replaces it every call)
        self._step = jax.jit(self._wrap(step_fn), donate_argnums=(0,))
        self._step1 = None  # lazily-built single-frame step for remainders
        self._step1_fn = step_fn
        self.frames = frames
        self.frame_size = frame_size
        self.states = tuple(b.init_state() for b in self._order)
        self._msg_handlers: dict[str, list[Callable]] = {}
        # observability: the reference's debug prints + benchmark timing
        # loops (SURVEY §5 tracing) become per-runner counters
        self.stats = {"steps": 0, "wall_s": 0.0, "samples": 0}

    def _wrap(self, step_fn: Callable) -> Callable:
        """Device-side multi-frame dispatch: lax.scan the single-frame step
        over K stacked feeds.  The per-frame state threading is identical
        to K separate step() calls (the scan carry IS the state pytree);
        tapped outputs and messages come back stacked on a leading K axis.
        This is the answer here to the reference's async worker thread
        (lib/clXCorrelate_impl.cc:1641-1698): instead of hiding per-call
        latency behind a host thread, K frames ride one dispatch."""
        k = self.steps_per_dispatch
        if k == 1:
            return step_fn

        if (self.vectorize
                and all(getattr(b, "stateless", False) for b in self._order)
                and self._graph._external):
            # Every block passes its carried state through UNCHANGED
            # (Block.stateless contract), so the K frames are fully
            # independent: vmap the step across the frame axis instead of
            # scanning it.  XLA then batches each block's per-frame
            # kernels into one large op — e.g. the FD correlator's K
            # separate 8192-pt FFT dispatches become a single [K·vecs,
            # 8192] batched FFT.
            def multi_step(states, feeds):
                tapped, messages = jax.vmap(
                    lambda feed: step_fn(states, feed)[1:])(feeds)
                return states, tapped, messages

            return multi_step

        def multi_step(states, feeds):
            def body(st, feed):
                st, tapped, msgs = step_fn(st, feed)
                return st, (tapped, msgs)

            states, (tapped, messages) = jax.lax.scan(
                body, states, feeds, length=k)
            return states, tapped, messages

        return multi_step

    def _ext_ranks(self) -> list[int]:
        """Expected per-frame feed rank for each external input.  Blocks
        whose frames are multi-dim (e.g. an X-Engine's [F, T, S] spectra)
        declare ``in_rank`` (an int, or a {port: int} dict); undeclared
        ports are flat rank-1 sample streams."""
        ranks = []
        for b, p in self._graph._external:
            r = getattr(b, "in_rank", 1)
            if isinstance(r, dict):
                r = r.get(p, 1)
            ranks.append(int(r))
        return ranks

    def on_message(self, key: str, handler: Callable) -> None:
        """Register a host callback for messages named '<block>.<port>'."""
        self._msg_handlers.setdefault(key, []).append(handler)

    def step(self, *feeds, stacked: bool | None = None) -> dict[str, jax.Array]:
        """Run one dispatch.  ``feeds`` are host arrays for the declared
        external inputs.

        With an EXPLICIT steps_per_dispatch=K > 1 the pre-round-4 contract
        holds: feeds must be stacked [K, frame_size] and tapped outputs
        carry a leading K axis.  In auto-dispatch mode (the compile()
        default) per-frame [frame_size] feeds — and no-feed source graphs
        — run through a dedicated single-frame jit with the original
        per-frame semantics; stacked [K, ...] feeds take the scanned
        K-frame dispatch.  Pass ``stacked=`` to override the shape-based
        detection (relevant only for multi-dim per-frame feeds whose
        leading axis happens to equal K)."""
        if len(feeds) != len(self._graph._external):
            raise ValueError(
                f"expected {len(self._graph._external)} feeds, got {len(feeds)}"
            )
        k = self.steps_per_dispatch
        if stacked is None:
            if k == 1:
                stacked = False
            elif self.auto_dispatch:
                arrs = [f.re if hasattr(f, "re") and hasattr(f, "im") else f
                        for f in feeds]
                # a stacked feed has exactly one axis MORE than the
                # destination block's declared per-frame feed rank
                # (``in_rank``, default 1 = flat sample stream) — so a
                # legitimately multi-dim per-frame feed whose leading dim
                # happens to equal K is no longer mis-detected
                ranks = self._ext_ranks()
                stacked = bool(arrs) and all(
                    np.ndim(a) == r + 1 and np.shape(a)[0] == k
                    for a, r in zip(arrs, ranks))
            else:
                stacked = True
        if not stacked:
            return self._step_single(*feeds)
        for i, f in enumerate(feeds):
            arr = f.re if hasattr(f, "re") and hasattr(f, "im") else f
            if np.shape(arr)[-1] != self.frame_size:
                raise ValueError(
                    f"feed {i} has {np.shape(arr)[-1]} samples, expected "
                    f"frame_size={self.frame_size}"
                )
            if np.shape(arr)[0] != k:
                raise ValueError(
                    f"feed {i}: steps_per_dispatch={k} needs stacked "
                    f"[{k}, frame_size] feeds, got {np.shape(arr)}")
        return self._step_multi(feeds)

    def _step_multi(self, feeds: tuple) -> dict[str, jax.Array]:
        """The scanned K-frame dispatch (no shape checks — step() and
        run() validate)."""
        import time as _time

        k = self.steps_per_dispatch
        t0 = _time.perf_counter()
        if self._precision is not None:
            # precision binds at TRACE time; wrapping every call keeps the
            # (cheap) context active whenever jit re-traces (first call,
            # post-refresh(), new input shapes)
            with jax.default_matmul_precision(self._precision):
                states, tapped, messages = self._step(self.states,
                                                      tuple(feeds))
        else:
            states, tapped, messages = self._step(self.states, tuple(feeds))
        self.states = states
        self._dispatch_messages(messages, k)
        self.stats["steps"] += k
        self.stats["wall_s"] += _time.perf_counter() - t0
        self.stats["samples"] += self.frame_size * k
        self._debug_report(k)
        return tapped

    # ---- per-block debug surface (the reference's setDebug +
    # CLPRINT_NITEMS, lib/GRCLBase.cpp:15) -------------------------------

    def _debug_report(self, k: int) -> None:
        for b in self._order:
            if not b.debug:
                continue
            label = b.name or type(b).__name__
            if not getattr(b, "_debug_dumped", False):
                b._debug_dumped = True
                try:
                    txt = self.lowered_text(b)
                    print(f"[clenabled_tpu debug] {label}: lowered HLO "
                          f"({len(txt.splitlines())} lines)\n{txt}")
                except Exception as e:  # lowering is best-effort
                    print(f"[clenabled_tpu debug] {label}: lowering "
                          f"unavailable ({e})")
            items = self.frames.get((id(b), 0))
            if items is None and b.n_inputs:   # sink: report consumed items
                items = self.frame_size
            print(f"[clenabled_tpu debug] {label}: {items} items/step × "
                  f"{k} steps (total steps {self.stats['steps']})")

    def lowered_text(self, block) -> str:
        """Lowered StableHLO of one block's apply at its in-graph input
        shapes (captured at trace time; requires the block to be marked
        ``set_debug()`` and at least one trace to have happened).  The
        analogue here of the reference printing its generated OpenCL kernel
        source in debug mode."""
        avals = getattr(block, "_debug_avals", None)
        if avals is None:
            raise ValueError(
                "no captured input signature — call set_debug() on the "
                "block before compile/step so the trace records it")
        st_aval, ins_aval = avals
        return jax.jit(
            lambda st, ins: block.apply(st, ins)
        ).lower(st_aval, ins_aval).as_text()

    def _dispatch_messages(self, messages: dict, k: int) -> None:
        for key, val in messages.items():
            handlers = self._msg_handlers.get(key)
            if not handlers:
                continue
            if k == 1:
                for h in handlers:
                    h(val)
            else:
                # handlers keep per-frame semantics: one call per sub-step
                for j in range(k):
                    sub = jax.tree.map(lambda a, j=j: a[j], val)
                    for h in handlers:
                        h(sub)

    def throughput_msps(self) -> float:
        """Dispatch-side samples/s since creation (JAX is async, so this is
        a lower bound unless the caller blocks on outputs)."""
        w = self.stats["wall_s"]
        return self.stats["samples"] / w / 1e6 if w else 0.0

    def run(self, feeds_iter, n_steps: int | None = None) -> list[dict]:
        """Drive from an iterator of PER-FRAME feed tuples; collects tapped
        outputs.  With steps_per_dispatch=K the runner stacks K frames
        host-side and dispatches them as one scanned device call (results
        carry a leading K axis); a remainder of fewer than K frames at the
        end of the iterator runs through a separate single-frame step, so
        every frame is processed.  JAX's async dispatch overlaps host feed
        prep with device compute (the role of the reference's
        double-buffered worker threads)."""
        k = self.steps_per_dispatch
        results = []
        group: list[tuple] = []

        def flush_group():
            feeds = tuple(
                jax.tree.map(lambda *xs: jnp.stack(xs), *(g[i] for g in group))
                for i in range(len(group[0])))
            group.clear()
            results.append(self._step_multi(feeds))

        for i, feeds in enumerate(feeds_iter):
            if n_steps is not None and i >= n_steps:
                break
            if k == 1:
                results.append(self.step(*feeds))
                continue
            group.append(tuple(feeds))
            if len(group) == k:
                flush_group()
        for feeds in group:          # remainder < K: single-frame fallback
            results.append(self._step_single(*feeds))
        return results

    def _step_single(self, *feeds) -> dict:
        """One frame through a dedicated single-frame jit (the per-frame
        step() path in auto-dispatch mode and run()'s sub-K remainder;
        state threading is shared with the scanned step)."""
        if self._step1 is None:
            self._step1 = jax.jit(self._step1_fn,
                                  donate_argnums=(0,))
        import time as _time

        t0 = _time.perf_counter()
        if self._precision is not None:
            with jax.default_matmul_precision(self._precision):
                states, tapped, messages = self._step1(self.states,
                                                       tuple(feeds))
        else:
            states, tapped, messages = self._step1(self.states, tuple(feeds))
        self.states = states
        self._dispatch_messages(messages, 1)
        self.stats["steps"] += 1
        self.stats["wall_s"] += _time.perf_counter() - t0
        self.stats["samples"] += self.frame_size
        self._debug_report(1)
        return tapped

    def reset(self) -> None:
        self.states = tuple(b.init_state() for b in self._order)

    # ---- live reconfiguration (the reference's runtime set_taps,
    # lib/clFilter_impl.cc:417-479: kernels/buffers rebuild while the
    # flowgraph keeps running) -------------------------------------------

    def refresh(self) -> None:
        """Re-trace the step after block reconfiguration (e.g. set_taps)
        and migrate every block's carried state into its new configuration
        (Block.migrate_state) — the stream continues without a reset.

        Raises if the new configuration is incompatible with the current
        frame size (quantum/rate checks re-run)."""
        order, step, frames, _ = self._graph._build(self.frame_size)
        if [id(b) for b in order] != [id(b) for b in self._order]:
            raise ValueError("refresh() cannot change the block set; "
                             "build a new flowgraph instead")
        self._step = jax.jit(self._wrap(step), donate_argnums=(0,))
        self._step1 = None
        self._step1_fn = step
        self.frames = frames
        self.states = tuple(
            b.migrate_state(st) for b, st in zip(self._order, self.states))

    def set_taps(self, block, taps) -> None:
        """Live filter retune: block.set_taps(taps) + refresh() in one call.
        The filter's carried tail is translated, not reset — where old and
        new taps agree the output stream is bit-identical to an
        uninterrupted run (tests/test_retune.py).

        Atomic: if the new taps are incompatible with the running graph
        (quantum/rate validation in refresh()), the block is rolled back to
        its pre-call configuration and the stream keeps running on the old
        taps — no half-applied retune."""
        snapshot = dict(block.__dict__)
        try:
            block.set_taps(taps)
            self.refresh()
        except Exception:
            block.__dict__.clear()
            block.__dict__.update(snapshot)
            raise

    # ---- checkpoint / resume -------------------------------------------
    # The reference has no checkpointing (SURVEY §5); its "state" hides in
    # block members and device buffers.  Here the entire flowgraph state is
    # one pytree, so streaming state (filter tails, loop phases, integration
    # accumulators) checkpoints in one call and a restarted process resumes
    # the stream sample-exactly.

    def save_state(self, path: str) -> None:
        import pickle

        flat, treedef = jax.tree.flatten(self.states)
        with open(path, "wb") as f:
            pickle.dump({"leaves": [np.asarray(x) for x in flat],
                         "treedef": treedef}, f)

    def load_state(self, path: str) -> None:
        import pickle

        with open(path, "rb") as f:
            data = pickle.load(f)
        flat, treedef = jax.tree.flatten(self.states)
        if treedef != data["treedef"]:
            raise ValueError("checkpoint does not match this flowgraph")
        self.states = jax.tree.unflatten(
            data["treedef"], [jnp.asarray(x) for x in data["leaves"]])
