"""REAL GNU Radio integration: runs the gr_compat
adapter inside a stock ``gnuradio`` top_block.  Auto-skips when GR is not
installed (it is not installable in this build image) — the day an
install appears, proof is ``pytest -k gr_real``.  Until then the adapter
contract is covered by the scheduler-faithful fake in
tests/test_gr_compat.py.

Reference contract being matched: the pybind11 blocks GR instantiates
directly, /root/reference/python/bindings/python_bindings.cc:29-49."""

import numpy as np
import pytest

gnuradio = pytest.importorskip("gnuradio")
from gnuradio import blocks as gr_blocks  # noqa: E402
from gnuradio import gr  # noqa: E402

from clenabled_tpu import blocks, gr_compat  # noqa: E402
from clenabled_tpu.dsp import firdes  # noqa: E402


def _run_top_block(src_data, block, sink_ctor):
    tb = gr.top_block()
    src = gr_blocks.vector_source_c(src_data.tolist(), False)
    wrapped = gr_compat.wrap(block)
    sink = sink_ctor()
    tb.connect(src, wrapped)
    tb.connect(wrapped, sink)
    tb.run()
    return np.asarray(sink.data())


def test_gr_real_lowpass_chain():
    rng = np.random.default_rng(0)
    n = 1 << 15
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    lpf = blocks.LowPassFilter(1, 1.0, 1e6, 100e3, 50e3)
    got = _run_top_block(x, lpf, gr_blocks.vector_sink_c)
    taps = firdes.low_pass(1.0, 1e6, 100e3, 50e3)
    want = np.convolve(x, taps)[: len(got)]
    np.testing.assert_allclose(got, want[: len(got)], rtol=1e-3, atol=1e-3)
    assert len(got) >= n // 2  # scheduler drained most of the stream


def test_gr_real_float_output_signature():
    """mag block: out_sig must default to float32 (out_kinds), so a
    vector_sink_f connects without explicit signatures."""
    rng = np.random.default_rng(1)
    n = 1 << 13
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    got = _run_top_block(x, blocks.ComplexToMag(), gr_blocks.vector_sink_f)
    np.testing.assert_allclose(got, np.abs(x)[: len(got)], rtol=1e-5,
                               atol=1e-5)
