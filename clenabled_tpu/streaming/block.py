"""Block protocol: the encoding here of GNU Radio's block contracts.

A block is pure and jit-traceable.  Its carried state (filter tails, loop
phase, integration accumulators — see SURVEY §5 "checkpoint/resume") is an
explicit pytree threaded by the scheduler, mirroring how the reference keeps
tails/phases in member variables or device buffers between work() calls
(e.g. lib/clFilter_impl.cc:663-677, lib/clCostasLoop_impl.cc:318-366).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any, Callable, Sequence


class Block:
    """Base class.  Subclasses override :meth:`apply` (pure, jittable).

    Attributes:
      n_inputs / n_outputs: stream port counts (0-input = source,
        0-output = sink).
      rate: outputs-per-input as a Fraction (1/decim for decimators,
        interp for interpolators) — GR's relative rate.
      quantum: input frame length must be a multiple of this (the role of
        set_output_multiple / OFA chunk sizing).
      source_frame: for sources, samples produced per step.
      in_kinds / out_kinds: per-port stream dtype kinds ("c" complex64,
        "f" float32, "i" int32, "s" int16, "b" int8 — the reference's
        DTYPE_* codes, include/clenabled/GRCLBase.h:57-62).  None means
        complex64 on every port.  Used by gr_compat.wrap to build correct
        GR io_signatures without the caller passing them (mag/arg/demod
        outputs are float32, not complex64).
    """

    n_inputs: int = 1
    n_outputs: int = 1
    rate: Fraction = Fraction(1)
    quantum: int = 1
    source_frame: int | None = None
    name: str = ""
    in_kinds: tuple[str, ...] | None = None
    out_kinds: tuple[str, ...] | None = None
    debug: bool = False
    # stateless=True is a CONTRACT: apply() returns the carried state
    # UNCHANGED and this frame's outputs depend only on (state, inputs) —
    # no cross-frame dependence.  When every block in a flowgraph is
    # stateless the Runner's K-frame dispatch vmaps the step across
    # frames instead of lax.scan-ning it, letting XLA batch the per-frame
    # kernels into single large ops (round 5: the bare-default block-API
    # FD xcorr went 0.88 → multi-GSPS from exactly this).  Blocks that
    # update state (filters, loops, sources, integrators) must keep False.
    stateless: bool = False

    def set_debug(self, debug: bool = True) -> "Block":
        """Per-block debug surface (the reference's ``setDebug`` +
        CLPRINT_NITEMS, lib/GRCLBase.cpp:15, lib/clFFT_impl.cc:647-648):
        the Runner logs this block's lowered HLO once at first dispatch
        (the analogue of the reference printing its generated OpenCL
        kernel source) and its per-dispatch item counts thereafter.
        Chainable: ``g.connect(Fft(2048).set_debug(), mag)``.  Also
        enabled by the legacy ``setDebug=True`` constructor kwarg."""
        self.debug = debug
        return self

    def init_state(self) -> Any:
        return ()

    def apply(self, state, inputs: Sequence) -> tuple[Any, tuple, dict]:
        """(state, inputs) -> (state', outputs, messages).

        ``messages`` maps port names to arrays/pytrees; the Runner hands
        them to host callbacks after each step (PDU analogue).
        """
        raise NotImplementedError

    def migrate_state(self, old_state) -> Any:
        """Map carried state across a live reconfiguration (Runner.refresh).

        The reference rebuilds kernels/buffers at runtime while the
        flowgraph keeps running (set_taps, lib/clFilter_impl.cc:417-479);
        here a reconfigured block translates its old state pytree into the
        new configuration's shape.  Default: identity (unchanged blocks
        keep their stream state).  Blocks whose reconfiguration changes the
        state shape MUST override this (see blocks.filters.Filter)."""
        return old_state

    def out_frame(self, in_frame: int) -> int:
        """Output frame length for a given input frame length."""
        if self.n_inputs == 0:
            assert self.source_frame is not None, f"{self} needs source_frame"
            return self.source_frame
        if in_frame % self.quantum:
            raise ValueError(
                f"{self.name or type(self).__name__}: frame {in_frame} not a "
                f"multiple of quantum {self.quantum}"
            )
        out = in_frame * self.rate
        if out.denominator != 1:
            raise ValueError(
                f"{self.name or type(self).__name__}: frame {in_frame} × rate "
                f"{self.rate} is not integral"
            )
        return int(out)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name or hex(id(self))})"


class FunctionBlock(Block):
    """Stateless block from a plain function over its input tuple."""

    stateless = True

    def __init__(self, fn: Callable, n_inputs: int = 1, n_outputs: int = 1,
                 rate: Fraction = Fraction(1), quantum: int = 1,
                 name: str = ""):
        self.fn = fn
        self.n_inputs = n_inputs
        self.n_outputs = n_outputs
        self.rate = rate
        self.quantum = quantum
        self.name = name

    def apply(self, state, inputs):
        out = self.fn(*inputs)
        if not isinstance(out, tuple):
            out = (out,)
        return state, out, {}
