"""Demodulator blocks: QuadratureDemod and CostasLoop."""

from __future__ import annotations

import jax.numpy as jnp

from clenabled_tpu.blocks._legacy import strip_legacy_kwargs
from clenabled_tpu.dsp import demod as dsp_demod
from clenabled_tpu.streaming.block import Block


class QuadratureDemod(Block):
    """clQuadratureDemod (lib/clQuadratureDemod_impl.cc): c→f FM/FSK
    discriminator, gain baked, 1-sample carried history.
    planar=True streams planar.PC frames."""

    out_kinds = ("f",)

    def __init__(self, gain: float, planar: bool = False, name: str = "",
                 **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.gain = gain
        self.planar = planar

    def init_state(self):
        if self.planar:
            from clenabled_tpu.dsp import planar as pl_mod

            z = jnp.zeros((1,), jnp.float32)
            return pl_mod.PC(z, jnp.zeros_like(z))
        return jnp.zeros((1,), jnp.complex64)

    def apply(self, state, inputs):
        if self.planar:
            y, last = dsp_demod.quadrature_demod_planar(
                inputs[0], self.gain, last_sample=state)
        else:
            y, last = dsp_demod.quadrature_demod(inputs[0], self.gain,
                                                 last_sample=state)
        return last, (y,), {}


class CostasLoop(Block):
    """clCostasLoop (lib/clCostasLoop_impl.cc): 2nd/4th-order carrier
    recovery.  planar=True streams planar.PC frames.

    Execution shapes (a single per-sample feedback chain is latency-bound
    on any hardware — the reference's single-work-item GPU kernel manages
    ~0.7 MSPS, README.md:64):

    * default: sequential lax.scan, the exact recurrence;
    * ``chunked=True`` (planar only): speculative chunk-parallel execution
      with seam certificates and exact branch correction
      (dsp.demod.make_costas_loop_chunked); publishes per-frame
      diagnostics on the "lock" message port;
    * ``num_streams=N``: N independent loops vmapped (per-channel carrier
      recovery), one port per stream.
    """

    msg_ports = ("lock",)

    def __init__(self, loop_bw: float, order: int, planar: bool = False,
                 chunked: bool = False, chunk: int = 8192,
                 warmup: int = 1024, num_streams: int = 1,
                 name: str = "", **legacy):
        strip_legacy_kwargs(legacy, self)
        self.name = name
        self.loop_bw = loop_bw
        self.order = order
        self.planar = planar
        self.chunked = chunked
        self.num_streams = num_streams
        if num_streams > 1:
            import jax

            self.n_inputs = self.n_outputs = num_streams
            if chunked:
                raise ValueError("chunked and num_streams are exclusive")
            base = (dsp_demod.make_costas_loop_planar(loop_bw, order)
                    if planar else dsp_demod.make_costas_loop(loop_bw, order))
            self._run = jax.vmap(base)
        elif chunked:
            if not planar:
                raise ValueError("chunked CostasLoop requires planar=True")
            self._run = dsp_demod.make_costas_loop_chunked(
                loop_bw, order, chunk=chunk, warmup=warmup)
            self.quantum = chunk
        elif planar:
            self._run = dsp_demod.make_costas_loop_planar(loop_bw, order)
        else:
            self._run = dsp_demod.make_costas_loop(loop_bw, order)

    def init_state(self):
        if self.num_streams > 1:
            s = self.num_streams
            return dsp_demod.CostasState(phase=jnp.zeros((s,), jnp.float32),
                                         freq=jnp.zeros((s,), jnp.float32),
                                         error=jnp.zeros((s,), jnp.float32))
        if self.chunked:
            return self._run.init_state()
        return dsp_demod.costas_init()

    def apply(self, state, inputs):
        if self.num_streams > 1:
            from clenabled_tpu.dsp import planar as pl_mod

            if isinstance(inputs[0], pl_mod.PC):
                fr = pl_mod.PC(jnp.stack([x.re for x in inputs]),
                               jnp.stack([x.im for x in inputs]))
                state, out = self._run(state, fr)
                outs = tuple(pl_mod.PC(out.re[i], out.im[i])
                             for i in range(self.num_streams))
            else:
                state, out = self._run(state, jnp.stack(inputs))
                outs = tuple(out[i] for i in range(self.num_streams))
            return state, outs, {}
        if self.chunked:
            state, out, diag = self._run(state, inputs[0])
            return state, (out,), {"lock": diag}
        state, out = self._run(state, inputs[0])
        return state, (out,), {}
