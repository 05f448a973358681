"""Generate GRC-style .block.yml descriptors for every block.

The reference ships 30 YAML block descriptors (grc/clenabled_*.block.yml)
defining the user-facing parameter surface; this emits the equivalent set
for clenabled_tpu into grc/ (documentation + any future GRC-like frontend).

    python -m clenabled_tpu.tools.gen_grc_yaml [--outdir grc]
"""

from __future__ import annotations

import argparse
import os

# (block id, label, category, make template, [(param id, label, default)])
BLOCKS = [
    ("clSignalSource", "Signal Source", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.SignalSource(${samp_rate}, ${waveform}, ${freq}, ${amplitude}, frame_size=${frame_size})",
     [("samp_rate", "Sample Rate", "samp_rate"), ("waveform", "Waveform (1=cos,2=sin)", "1"),
      ("freq", "Frequency", "1000"), ("amplitude", "Amplitude", "1.0"),
      ("frame_size", "Frame Size", "8192")]),
    ("clFFT", "FFT", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.Fft(${fft_size}, direction=${direction}, window=${window}, shift=${shift}, num_streams=${num_streams})",
     [("fft_size", "FFT Size", "2048"), ("direction", "Direction (1=fwd,-1=rev)", "1"),
      ("window", "Window Taps", "None"), ("shift", "Shift", "False"),
      ("num_streams", "Num Streams", "1")]),
    ("clMultiply", "Multiply", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.Multiply()", []),
    ("clAdd", "Add", "[GPU-Accelerated]", "clenabled_tpu.blocks.Add()", []),
    ("clSubtract", "Subtract", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.Subtract()", []),
    ("clMultiplyConjugate", "Multiply Conjugate", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.MultiplyConjugate()", []),
    ("clComplexConjugate", "Complex Conjugate", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.ComplexConjugate()", []),
    ("clMultConst", "Multiply Const", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.MultiplyConst(${k})", [("k", "Constant", "1.0")]),
    ("clAddConst", "Add Const", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.AddConst(${k})", [("k", "Constant", "0.0")]),
    ("clComplexToMag", "Complex To Mag", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.ComplexToMag()", []),
    ("clComplexToArg", "Complex To Arg", "[GPU-Enabled]",
     "clenabled_tpu.blocks.ComplexToArg()", []),
    ("clComplexToMagPhase", "Complex To Mag Phase", "[GPU-Enabled]",
     "clenabled_tpu.blocks.ComplexToMagPhase()", []),
    ("clMagPhaseToComplex", "Mag Phase To Complex", "[GPU-Enabled]",
     "clenabled_tpu.blocks.MagPhaseToComplex()", []),
    ("clLog10", "Log10", "[GPU-Enabled]",
     "clenabled_tpu.blocks.Log(nValue=${n}, kValue=${k})",
     [("n", "n (n*log10(x)+k)", "1.0"), ("k", "k", "0.0")]),
    ("clLog", "Log", "[GPU-Enabled]",
     "clenabled_tpu.blocks.Log(nValue=${n}, kValue=${k})",
     [("n", "n (n*log10(x)+k)", "1.0"), ("k", "k", "0.0")]),
    ("clSNR", "SNR Helper", "[GPU-Enabled]",
     "clenabled_tpu.blocks.SNRHelper(nValue=${n}, kValue=${k})",
     [("n", "n", "10.0"), ("k", "k", "0.0")]),
    ("clKernel1To1", "Custom Kernel 1:1", "[GPU-Enabled]",
     "clenabled_tpu.blocks.Kernel1To1(filename=${filename}, kernelFnName=${fnname})",
     [("filename", "Kernel File (.py)", "''"), ("fnname", "Function Name", "''")]),
    ("clKernel2To1", "Custom Kernel 2:1", "[GPU-Enabled]",
     "clenabled_tpu.blocks.Kernel2To1(filename=${filename}, kernelFnName=${fnname})",
     [("filename", "Kernel File (.py)", "''"), ("fnname", "Function Name", "''")]),
    ("clLowPassFilter", "Low Pass Filter", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.LowPassFilter(${decimation}, ${gain}, ${samp_rate}, ${cutoff_freq}, ${transition_width}, use_time=${use_time})",
     [("decimation", "Decimation", "1"), ("gain", "Gain", "1.0"),
      ("samp_rate", "Sample Rate", "samp_rate"), ("cutoff_freq", "Cutoff Freq", "100e3"),
      ("transition_width", "Transition Width", "50e3"),
      ("use_time", "Time Domain (vs OFA)", "False")]),
    ("clHighPassFilter", "High Pass Filter", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.HighPassFilter(${decimation}, ${gain}, ${samp_rate}, ${cutoff_freq}, ${transition_width}, use_time=${use_time})",
     [("decimation", "Decimation", "1"), ("gain", "Gain", "1.0"),
      ("samp_rate", "Sample Rate", "samp_rate"), ("cutoff_freq", "Cutoff Freq", "100e3"),
      ("transition_width", "Transition Width", "50e3"),
      ("use_time", "Time Domain", "False")]),
    ("clBandPassFilter", "Band Pass Filter", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.BandPassFilter(${decimation}, ${gain}, ${samp_rate}, ${low_cutoff}, ${high_cutoff}, ${transition_width}, use_time=${use_time})",
     [("decimation", "Decimation", "1"), ("gain", "Gain", "1.0"),
      ("samp_rate", "Sample Rate", "samp_rate"), ("low_cutoff", "Low Cutoff", "100e3"),
      ("high_cutoff", "High Cutoff", "200e3"),
      ("transition_width", "Transition Width", "50e3"),
      ("use_time", "Time Domain", "False")]),
    ("clBandRejectFilter", "Band Reject Filter", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.BandRejectFilter(${decimation}, ${gain}, ${samp_rate}, ${low_cutoff}, ${high_cutoff}, ${transition_width}, use_time=${use_time})",
     [("decimation", "Decimation", "1"), ("gain", "Gain", "1.0"),
      ("samp_rate", "Sample Rate", "samp_rate"), ("low_cutoff", "Low Cutoff", "100e3"),
      ("high_cutoff", "High Cutoff", "200e3"),
      ("transition_width", "Transition Width", "50e3"),
      ("use_time", "Time Domain", "False")]),
    ("clRootRaisedCosine", "RRC Filter", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.RootRaisedCosineFilter(${decimation}, ${gain}, ${samp_rate}, ${symbol_rate}, ${alpha}, ${ntaps}, use_time=${use_time})",
     [("decimation", "Decimation", "1"), ("gain", "Gain", "1.0"),
      ("samp_rate", "Sample Rate", "samp_rate"), ("symbol_rate", "Symbol Rate", "1e6"),
      ("alpha", "Alpha", "0.35"), ("ntaps", "Num Taps", "241"),
      ("use_time", "Time Domain", "False")]),
    ("clFIRTapFilter", "FIR Tap Filter", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.FIRTapFilter(${decimation}, ${taps}, use_time=${use_time})",
     [("decimation", "Decimation", "1"), ("taps", "Taps", "[]"),
      ("use_time", "Time Domain", "False")]),
    ("clComplexFilter", "Complex Tap Filter", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.ComplexFilter(${decimation}, ${taps}, use_time=${use_time})",
     [("decimation", "Decimation", "1"), ("taps", "Complex Taps", "[]"),
      ("use_time", "Time Domain", "True")]),
    ("clPolyphaseChannelizer", "Polyphase Channelizer", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.PolyphaseChannelizer(${taps}, ${buf_items}, ${num_channels}, ${ninputs_per_iter}, ${ch_map})",
     [("taps", "Prototype Taps", "[]"), ("buf_items", "Buffer Items", "6000"),
      ("num_channels", "Num Channels", "16"),
      ("ninputs_per_iter", "Inputs Per Iteration", "16"),
      ("ch_map", "Channel Map", "list(range(16))")]),
    ("clQuadratureDemod", "Quadrature Demod", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.QuadratureDemod(${gain})",
     [("gain", "Gain", "1.0")]),
    ("clCostasLoop", "Costas Loop", "[GPU-Enabled]",
     "clenabled_tpu.blocks.CostasLoop(${loop_bw}, ${order}, planar=${planar}, chunked=${chunked})",
     [("loop_bw", "Loop Bandwidth", "0.02"), ("order", "Order (2 or 4)", "2"),
      ("planar", "Planar (complex-free path)", "True"),
      ("chunked", "Speculative Chunked (locked streams)", "False")]),
    ("clXCorrelate", "Cross Correlator (TD)", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.XCorrelate(${num_inputs}, signal_length=${signal_length}, max_search_index=${max_search}, decim_frames=${decim_frames})",
     [("num_inputs", "Num Inputs", "2"), ("signal_length", "Analysis Window", "8192"),
      ("max_search", "Max Search Lags", "512"),
      ("decim_frames", "Process 1 in N Frames", "4")]),
    ("clxcorrelate_fft_vcf", "Cross Correlator (FD)", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.XCorrelateFFTVCF(${fft_size}, ${num_inputs}, input_type=${input_type})",
     [("fft_size", "FFT Size", "2048"), ("num_inputs", "Num Inputs", "2"),
      ("input_type", "Input (1=spectra,2=time)", "1")]),
    ("clXEngine", "X-Engine (FX Correlator)", "[GPU-Accelerated]",
     "clenabled_tpu.blocks.XEngine(${data_type}, ${polarization}, ${num_inputs}, num_channels=${num_channels}, integration=${integration}, antenna_list=${antenna_list})",
     [("data_type", "Input (1=complex,5=IChar,6=Packed4)", "1"),
      ("polarization", "Polarizations", "2"), ("num_inputs", "Num Antennas", "4"),
      ("num_channels", "Channels", "256"), ("integration", "Integration Frames", "1024"),
      ("antenna_list", "Antenna Names", "[]")]),
]


# Stream/message port declarations per block id: (inputs, outputs) where a
# stream port is (label, dtype, multiplicity_expr|None) and a message port
# is ("msg", port_name).  These make the descriptors actually loadable in
# GNU Radio Companion (ports are required), with templates instantiating
# real JAX blocks through gr_compat.wrap — the role of the reference's
# pybind bindings (python/bindings/python_bindings.cc:29-49).
IO = {
    "clSignalSource": ([], [("out", "complex", None)]),
    "clFFT": ([("in", "complex", "${num_streams}")],
              [("out", "complex", "${num_streams}")]),
    "clMultiply": ([("a", "complex", None), ("b", "complex", None)],
                   [("out", "complex", None)]),
    "clAdd": ([("a", "complex", None), ("b", "complex", None)],
              [("out", "complex", None)]),
    "clSubtract": ([("a", "complex", None), ("b", "complex", None)],
                   [("out", "complex", None)]),
    "clMultiplyConjugate": ([("a", "complex", None), ("b", "complex", None)],
                            [("out", "complex", None)]),
    "clComplexConjugate": ([("in", "complex", None)],
                           [("out", "complex", None)]),
    "clMultConst": ([("in", "complex", None)], [("out", "complex", None)]),
    "clAddConst": ([("in", "complex", None)], [("out", "complex", None)]),
    "clComplexToMag": ([("in", "complex", None)], [("out", "float", None)]),
    "clComplexToArg": ([("in", "complex", None)], [("out", "float", None)]),
    "clComplexToMagPhase": ([("in", "complex", None)],
                            [("mag", "float", None),
                             ("phase", "float", None)]),
    "clMagPhaseToComplex": ([("mag", "float", None), ("phase", "float", None)],
                            [("out", "complex", None)]),
    "clLog10": ([("in", "float", None)], [("out", "float", None)]),
    "clLog": ([("in", "float", None)], [("out", "float", None)]),
    "clSNR": ([("in", "float", None)], [("out", "float", None)]),
    "clKernel1To1": ([("in", "complex", None)], [("out", "complex", None)]),
    "clKernel2To1": ([("a", "complex", None), ("b", "complex", None)],
                     [("out", "complex", None)]),
    "clLowPassFilter": ([("in", "complex", None)], [("out", "complex", None)]),
    "clHighPassFilter": ([("in", "complex", None)], [("out", "complex", None)]),
    "clBandPassFilter": ([("in", "complex", None)], [("out", "complex", None)]),
    "clBandRejectFilter": ([("in", "complex", None)],
                           [("out", "complex", None)]),
    "clRootRaisedCosine": ([("in", "complex", None)],
                           [("out", "complex", None)]),
    "clFIRTapFilter": ([("in", "complex", None)], [("out", "complex", None)]),
    "clComplexFilter": ([("in", "complex", None)], [("out", "complex", None)]),
    "clPolyphaseChannelizer": ([("in", "complex", None)],
                               [("out", "complex", None)]),
    "clQuadratureDemod": ([("in", "complex", None)], [("out", "float", None)]),
    "clCostasLoop": ([("in", "complex", None)],
                     [("out", "complex", None), ("msg", "lock")]),
    "clXCorrelate": ([("in", "complex", "${num_inputs}")],
                     [("msg", "corr")]),
    "clxcorrelate_fft_vcf": ([("in", "complex", "${num_inputs}")],
                             [("out", "float", "${ num_inputs - 1 }")]),
    "clXEngine": ([("in", "complex", "${num_inputs}")], [("msg", "xcorr")]),
}

# blocks whose stream signatures aren't all-complex need explicit numpy
# signatures passed to wrap()
SIGS = {
    "clComplexToMag": (None, "[np.float32]"),
    "clComplexToArg": (None, "[np.float32]"),
    "clComplexToMagPhase": (None, "[np.float32, np.float32]"),
    "clMagPhaseToComplex": ("[np.float32, np.float32]", None),
    "clLog10": ("[np.float32]", "[np.float32]"),
    "clLog": ("[np.float32]", "[np.float32]"),
    "clSNR": ("[np.float32]", "[np.float32]"),
    "clQuadratureDemod": (None, "[np.float32]"),
    "clxcorrelate_fft_vcf":
        ("[np.complex64] * ${num_inputs}",
         "[np.float32] * (${num_inputs} - 1)"),
}


def _port_lines(ports, direction):
    lines = [f"{direction}:"]
    for port in ports:
        if port[0] == "msg":
            lines += [f"- domain: message", f"  id: {port[1]}",
                      "  optional: true"]
        else:
            label, dtype, mult = port
            lines += [f"- label: {label}", f"  dtype: {dtype}"]
            if mult:
                lines.append(f"  multiplicity: {mult}")
    return lines + [""]


def emit(block, outdir: str) -> str:
    bid, label, category, template, params = block
    in_sig, out_sig = SIGS.get(bid, (None, None))
    wrap_args = ""
    if in_sig:
        wrap_args += f", in_sig={in_sig}"
    if out_sig:
        wrap_args += f", out_sig={out_sig}"
    make = f"clenabled_tpu.gr_compat.wrap({template}{wrap_args})"
    lines = [
        f"id: clenabled_tpu_{bid}",
        f"label: {label}",
        f"category: '{category}'",
        "",
        "templates:",
        "  imports: |-",
        "    import numpy as np",
        "    import clenabled_tpu.blocks",
        "    import clenabled_tpu.gr_compat",
        f"  make: {make}",
        "",
    ]
    if params:
        lines.append("parameters:")
        for pid, plabel, default in params:
            lines += [f"- id: {pid}", f"  label: {plabel}",
                      f"  default: {default!r}" if not str(default).isidentifier()
                      else f"  default: {default}"]
        lines.append("")
    ins, outs = IO[bid]
    if ins:
        lines += _port_lines(ins, "inputs")
    if outs:
        lines += _port_lines(outs, "outputs")
    lines += [
        "documentation: |-",
        f"  JAX equivalent of gr-clenabled's {bid} block.",
        "  Instantiated inside GNU Radio through clenabled_tpu.gr_compat.wrap",
        "  (the accelerator does the math, GR does the stream plumbing).",
        "  See clenabled_tpu/blocks and PARITY.md for semantics and",
        "  reference citations.",
        "",
        "file_format: 1",
    ]
    path = os.path.join(outdir, f"clenabled_tpu_{bid}.block.yml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="grc")
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)
    for b in BLOCKS:
        emit(b, args.outdir)
    print(f"wrote {len(BLOCKS)} descriptors to {args.outdir}/")


if __name__ == "__main__":
    main()
