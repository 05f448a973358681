"""GNU Radio Companion loadability shim.

The reference makes every block instantiable from GRC through pybind11
bindings (python/bindings/python_bindings.cc:29-49) plus 30 .block.yml
descriptors (grc/clenabled_clFFT.block.yml:84-89).  Here the equivalent is
:func:`wrap`: it adapts any clenabled_tpu :class:`~clenabled_tpu.streaming.
block.Block` into a ``gr.basic_block`` so the generated descriptors in
``grc/`` (see tools/gen_grc_yaml.py) instantiate real JAX blocks inside a
stock GNU Radio flowgraph — the accelerator does the math, GR does the
plumbing.

GNU Radio is an OPTIONAL runtime dependency: this module imports it only
inside :func:`wrap`, so the rest of the package never requires it.  The
adapter logic itself is unit-tested against a minimal fake ``gr`` module
(tests/test_gr_compat.py) since GR isn't installable in the build image.

Contract mapping (GR ↔ Block):

====================  =====================================================
GR concept            Block concept
====================  =====================================================
io_signature          n_inputs / n_outputs (dtype from the .yml descriptor)
forecast()            quantum (input frames must be multiples of it)
relative rate         rate (Fraction: 1/decim or interp)
work state            init_state() pytree carried across general_work calls
message ports         the ``messages`` dict returned by apply()
====================  =====================================================
"""

from __future__ import annotations

import math

import numpy as np


def _to_numpy(y):
    """Block output leaf → numpy (handles planar.PC and jax arrays).
    Planar pairs assemble straight into complex64 — no complex128
    intermediate on the per-work-call hot path."""
    from clenabled_tpu.dsp import planar

    if isinstance(y, planar.PC):
        out = np.empty(np.shape(y.re), np.complex64)
        out.real = np.asarray(y.re)
        out.imag = np.asarray(y.im)
        return out
    return np.asarray(y)


_KIND_DTYPE = {  # the reference's DTYPE_* codes, GRCLBase.h:57-62
    "c": np.complex64, "f": np.float32, "i": np.int32,
    "s": np.int16, "b": np.int8,
}


def _sig_from_kinds(kinds, n_ports):
    if kinds is None:
        return [np.complex64] * n_ports
    if len(kinds) != n_ports:
        raise ValueError(f"kinds {kinds} do not cover {n_ports} ports")
    return [_KIND_DTYPE[k] for k in kinds]


def wrap(block, in_sig=None, out_sig=None, msg_ports=None, name=None,
         max_frames_pow2: int = 17, batch_frames: int | str = "auto",
         pipeline_depth: int | str = "auto"):
    """Adapt a clenabled_tpu Block into a ``gr.basic_block``.

    Args:
      block: any Block instance (blocks.Fft(...), blocks.XEngine(...), ...).
      in_sig / out_sig: numpy dtypes per port; default derived from the
        block's declared ``in_kinds``/``out_kinds`` (mag/arg/demod blocks
        declare float32 outputs; undeclared ports default to complex64).
      msg_ports: names to register as GR message outputs.  Default: the
        block's ``msg_ports`` attribute if present, else none — unknown
        message keys are dropped (GR requires ports registered up front).
      name: GR block name (default: the block's class name).
      max_frames_pow2: cap on the per-call frame bucket (2**k samples).
      batch_frames: device-dispatch batching (round 4).  ``1`` = one
        apply() per general_work call (the pre-round-4 behavior).
        ``"auto"`` (default) / an int K enables BACKPRESSURE-ADAPTIVE
        batching: when the scheduler's offers are at least one batch
        frame (quantum·2^j, ≤ 2^13 samples), consumed frames accumulate
        and ride ONE device dispatch per K frames via lax.scan — the
        same device-side batching Runner.steps_per_dispatch does for
        standalone flowgraphs.  When offers are smaller than a
        batch frame (throttled/live sources, draining streams), pending
        frames flush through a per-frame jit and the sub-frame offer
        takes the original bucketed path — so latency-sensitive
        trickling streams keep per-call behavior, and batching engages
        exactly when the upstream is fast enough for throughput to
        matter.  Messages are published per frame, in order, at
        dispatch time.  At flowgraph termination up to K-1 consumed
        frames can remain pending; call ``flush()`` (e.g. after
        ``tb.wait()``) to force them through.
      pipeline_depth: per-call DISPATCH PIPELINING — the answer here to
        the reference's async double-buffered worker
        (lib/clXCorrelate_impl.cc:1641-1698).  JAX dispatch is
        asynchronous, so the only per-call sync point is fetching
        results to host; with depth D the adapter keeps up to D-1
        dispatched frames in flight and fetches the OLDEST one each
        call, overlapping the host fetch/publish of frame N-1 with the
        device compute of frame N.  Results therefore trail by up to
        D-1 work calls (contract-legal for a general block; the
        reference's async mode trails identically) and ``flush()`` /
        the stop() callback drain the tail.  ``"auto"`` (default)
        enables depth 2 for SINK blocks (message-only outputs — the
        correlator sinks, where trailing publishes are the reference's
        own async semantics) and keeps stream blocks at depth 1
        (same-call output, the pre-round-5 behavior).

    Returns a gr.basic_block instance ready for ``tb.connect(...)``.

    Retrace bounding: GR hands general_work whatever buffer sizes its
    scheduler produces, and every distinct size would re-trace the
    block's jitted internals (an unbounded-recompile hazard).  The
    adapter therefore processes quantum·2^k frame BUCKETS — the largest
    power-of-two multiple of the quantum that fits the available input
    and output space — consuming only that much (trimming is
    contract-legal for a general block; GR re-offers the remainder next
    call).  The jit cache is then bounded by log2(max buffer size)
    entries per block; the batch path adds at most two fixed-shape
    entries (the K-frame scan and the single-frame flush).
    """
    from gnuradio import gr  # optional dependency, imported lazily
    import pmt

    import jax.numpy as jnp
    from clenabled_tpu.dsp import planar

    n_in = block.n_inputs
    n_out = block.n_outputs
    if in_sig is None:
        in_sig = _sig_from_kinds(getattr(block, "in_kinds", None), n_in)
    if out_sig is None:
        out_sig = _sig_from_kinds(getattr(block, "out_kinds", None), n_out)
    if msg_ports is None:
        msg_ports = tuple(getattr(block, "msg_ports", ()))
    planar_mode = bool(getattr(block, "planar", False))
    rate = block.rate
    quantum = max(1, int(block.quantum))

    # --- batch-dispatch sizing (round 4): batch frame bf = quantum·2^j
    # capped at 2^13 samples (the reference's GR-buffer scale), K sized so
    # one dispatch carries ~2^21 samples — the same rule as
    # Flowgraph.compile(steps_per_dispatch="auto")
    if n_in:
        bf = quantum
        while bf * 2 <= max(quantum, 1 << 13):
            bf *= 2
    else:
        bf = int(getattr(block, "source_frame", None) or 1)
    if batch_frames == "auto":
        bk = max(1, min(64, (1 << 21) // max(1, bf)))
    else:
        bk = max(1, int(batch_frames))
    if pipeline_depth == "auto":
        depth = 2 if (n_in and not n_out) else 1
    else:
        depth = max(1, int(pipeline_depth))

    def to_device(x, sig_dtype):
        if planar_mode and np.issubdtype(sig_dtype, np.complexfloating):
            return planar.from_complex(np.ascontiguousarray(x))
        return jnp.asarray(np.ascontiguousarray(x))

    class _WrappedBlock(gr.basic_block):
        def __init__(self):
            gr.basic_block.__init__(
                self, name=name or type(block).__name__,
                in_sig=list(in_sig), out_sig=list(out_sig))
            self._blk = block
            self._state = block.init_state()
            if n_in and rate != 1:
                self.set_relative_rate(float(rate))
            out_items = quantum * rate
            if n_out and out_items.denominator == 1 and out_items > 1:
                self.set_output_multiple(int(out_items))
            self._msg_port_syms = {}
            for port in msg_ports:
                sym = pmt.intern(port)
                self.message_port_register_out(sym)
                self._msg_port_syms[port] = sym
            # batch-dispatch state (bk > 1): pending input frames per port,
            # output queue segments per port, lazily-built jits
            self._pend = [[] for _ in range(n_in)]
            self._outq = [[] for _ in range(max(1, n_out))]
            self._scan = None
            self._one = None
            # per-call pipelining (depth > 1): dispatched-but-unfetched
            # (outputs, messages) device futures, oldest first
            self._inflight = []
            self._fetch_pool = None   # lazy thread pool for msg fetches
            # per-call jit cache (round 5): block.apply is designed to be
            # TRACED (inside the Runner's jitted step); calling it eagerly
            # dispatches op-by-op — ~1 ms per op through a remote runtime,
            # seconds per work call for a correlator.  Keyed by the
            # bucketed frame length, so the cache is bounded by the same
            # log2(max buffer) argument as the retrace bound above.
            self._percall_jits = {}

        def forecast(self, noutput_items, ninputs):
            need = int(math.ceil(noutput_items / float(rate))) if n_out else quantum
            need = max(quantum, ((need + quantum - 1) // quantum) * quantum)
            return [need] * ninputs

        def _publish(self, msgs):
            for port, payload in msgs.items():
                sym = self._msg_port_syms.get(port)
                if sym is None:
                    continue
                if isinstance(payload, dict) and len(payload) > 1:
                    # fetch the payload's arrays CONCURRENTLY so their
                    # device→host copies overlap instead of adding up (a
                    # correlator message carries several)
                    if self._fetch_pool is None:
                        from concurrent.futures import ThreadPoolExecutor

                        self._fetch_pool = ThreadPoolExecutor(8)
                    keys = list(payload.keys())
                    vals = list(self._fetch_pool.map(
                        _to_numpy, [payload[k] for k in keys]))
                    as_np = dict(zip(keys, vals))
                elif isinstance(payload, dict):
                    as_np = {k: _to_numpy(v) for k, v in payload.items()}
                else:
                    as_np = _to_numpy(payload)
                self.message_port_pub(sym, pmt.to_pmt(as_np))

        def general_work(self, input_items, output_items):
            if bk == 1:
                return self._work_percall(input_items, output_items)
            return self._work_batched(input_items, output_items)

        def _work_percall(self, input_items, output_items):
            if n_in:
                avail = min(len(x) for x in input_items)
                frames = (avail // quantum) * quantum
                if n_out:
                    out_cap = min(len(o) for o in output_items)
                    # largest quantum multiple whose output fits
                    while frames > 0 and int(frames * rate) > out_cap:
                        frames -= quantum
                # bucket to quantum·2^k (bounded retraces — see docstring)
                if frames >= quantum:
                    k = (frames // quantum).bit_length() - 1
                    cap = max(0, max_frames_pow2 - (quantum.bit_length() - 1))
                    frames = quantum * (1 << min(k, cap))
                if frames <= 0:
                    # nothing to consume — but pipelined output may still
                    # be pending: drain it so trailing frames reach the
                    # stream as the scheduler keeps offering output space
                    # (GR calls work with dwindling input while the
                    # flowgraph winds down)
                    if n_out and (self._inflight or self._q_len()):
                        self._drain_inflight()
                        return self._emit(output_items)
                    return 0
                ins = [to_device(x[:frames], s)
                       for x, s in zip(input_items, in_sig)]
            else:
                frames = 0
                ins = []
                if block.source_frame is None:
                    raise RuntimeError("source block needs source_frame")
                if output_items and len(output_items[0]) < block.source_frame:
                    return 0
            key = frames
            fn = self._percall_jits.get(key)
            if fn is None:
                import jax

                blk = self._blk
                fn = jax.jit(lambda st, i_: blk.apply(st, list(i_)))
                self._percall_jits[key] = fn
            self._state, outs, msgs = fn(self._state, tuple(ins))
            if n_in:
                self.consume_each(frames)
            if depth > 1:
                # dispatch is async — defer the host fetch so frame N's
                # device compute overlaps frame N-1's fetch/publish (the
                # reference's async double-buffered worker, see wrap())
                self._inflight.append((outs, msgs))
                if len(self._inflight) >= depth:
                    self._fetch_oldest()
                return self._emit(output_items) if n_out else 0
            self._publish(msgs)
            if not n_out:
                return 0
            nout = len(_to_numpy(outs[0]).ravel()) if outs else 0
            for o, y in zip(output_items, outs):
                arr = _to_numpy(y).ravel()
                o[:len(arr)] = arr.astype(o.dtype, copy=False)
            return nout

        # ---- batched dispatch (round 4): accumulate bf-sample frames,
        # run K per lax.scan device call, drain through an output queue.
        # Engages only when the scheduler's offers reach one batch frame;
        # trickling offers keep the per-call path (latency-preserving).

        def _fetch_oldest(self):
            """Fetch the oldest in-flight dispatch to host: stream
            outputs into the output queue, messages published in order."""
            outs, msgs = self._inflight.pop(0)
            for p, y in enumerate(outs):
                self._outq[p].append(_to_numpy(y).ravel())
            self._publish(msgs)

        def _drain_inflight(self):
            while self._inflight:
                self._fetch_oldest()

        def _q_len(self):
            return sum(len(a) for a in self._outq[0]) if self._outq else 0

        def _emit(self, output_items):
            if not n_out or not output_items or not self._outq:
                return 0
            space = min(len(o) for o in output_items)
            emitted = 0
            while emitted < space and self._outq[0]:
                take = min(space - emitted, len(self._outq[0][0]))
                for p, o in enumerate(output_items):
                    seg = self._outq[p][0]
                    o[emitted:emitted + take] = seg[:take].astype(
                        o.dtype, copy=False)
                    if take == len(seg):
                        self._outq[p].pop(0)
                    else:
                        self._outq[p][0] = seg[take:]
                emitted += take
            return emitted

        def _queue_outs(self, stacked_outs, k):
            """Stacked [k, ...] device outputs → per-port queue segments."""
            for p, y in enumerate(stacked_outs):
                arr = _to_numpy(y)
                self._outq[p].append(arr.reshape(k, -1).reshape(-1))

        def _publish_stacked(self, msgs, k):
            if not msgs or not self._msg_port_syms:
                return
            import jax

            for j in range(k):
                self._publish(jax.tree.map(lambda a, j=j: a[j], msgs))

        def _scan_fn(self):
            if self._scan is None:
                import jax

                blk = self._blk

                def body(st, fr):
                    st, outs, ms = blk.apply(st, [] if fr is None
                                             else list(fr))
                    return st, (tuple(outs), ms)

                if n_in and getattr(blk, "stateless", False):
                    # stateless contract: frames are independent — vmap
                    # the K-frame dispatch so XLA batches the per-frame
                    # kernels (same win as the Runner's round-5 vmap
                    # dispatch; outputs keep the leading K axis)
                    def vmapped(st, xs):
                        outs, ms = jax.vmap(
                            lambda fr: body(st, fr)[1])(xs)
                        return st, (outs, ms)

                    self._scan = jax.jit(vmapped)
                elif n_in:
                    self._scan = jax.jit(
                        lambda st, xs: jax.lax.scan(body, st, xs))
                else:
                    self._scan = jax.jit(
                        lambda st: jax.lax.scan(body, st, None, length=bk))
            return self._scan

        def _dispatch_group(self):
            self._drain_inflight()   # keep queue order across path mixes
            k = bk
            xs = tuple(
                to_device(np.stack(self._pend[p][:k]), s)
                for p, s in zip(range(n_in), in_sig))
            for p in range(n_in):
                del self._pend[p][:k]
            self._state, (outs, msgs) = self._scan_fn()(self._state, xs)
            self._queue_outs(outs, k)
            self._publish_stacked(msgs, k)

        def flush(self):
            """Force pending consumed-but-unprocessed frames through a
            per-frame jit and fetch any in-flight dispatches (call after
            tb.wait() to drain the tail)."""
            self._drain_inflight()
            if not n_in or not self._pend or not self._pend[0]:
                return
            if self._one is None:
                import jax

                blk = self._blk
                self._one = jax.jit(lambda st, ins: blk.apply(st, ins))
            while self._pend[0]:
                ins = [to_device(self._pend[p].pop(0), s)
                       for p, s in zip(range(n_in), in_sig)]
                self._state, outs, msgs = self._one(self._state, ins)
                self._queue_outs([y[None] if not isinstance(y, planar.PC)
                                  else planar.PC(y.re[None], y.im[None])
                                  for y in outs], 1)
                self._publish(msgs)

        def stop(self):
            """GR scheduler stop callback (runs at flowgraph termination):
            drain consumed-but-unprocessed batch frames so their MESSAGES
            publish and the output queue is complete — without this, up to
            K-1 pending frames would be silently dropped unless the caller
            knew to invoke flush() after tb.wait().  Stream
            samples still queued here have no further work call to emit
            through, but nothing is lost on the message path and a final
            producer-driven work call can still drain _outq."""
            self.flush()
            if self._fetch_pool is not None:
                self._fetch_pool.shutdown(wait=False)
                self._fetch_pool = None
            base_stop = getattr(gr.basic_block, "stop", None)
            return base_stop(self) if callable(base_stop) else True

        def _work_batched(self, input_items, output_items):
            if not n_in:
                if block.source_frame is None:
                    raise RuntimeError("source block needs source_frame")
                if self._q_len() == 0:
                    self._state, (outs, msgs) = self._scan_fn()(self._state)
                    self._queue_outs(outs, bk)
                    self._publish_stacked(msgs, bk)
                return self._emit(output_items)
            avail = min(len(x) for x in input_items)
            nf = avail // bf
            if nf > 0:
                room = max(0, 2 * bk - len(self._pend[0]))
                take = min(nf, room)
                if take:
                    for p, x in enumerate(input_items):
                        for j in range(take):
                            self._pend[p].append(
                                np.ascontiguousarray(x[j * bf:(j + 1) * bf]))
                    self.consume_each(take * bf)
                cap = 2 * bk * max(1, int(bf * rate))
                while len(self._pend[0]) >= bk and self._q_len() <= cap:
                    self._dispatch_group()
            else:
                # trickle/drain: flush pending first; the sub-frame offer
                # takes the per-call path once nothing is queued ahead of
                # it (order preservation — GR re-offers next call)
                if self._pend and self._pend[0]:
                    self.flush()
                elif self._q_len() == 0 and avail >= quantum:
                    return self._work_percall(input_items, output_items)
            return self._emit(output_items)

    return _WrappedBlock()
