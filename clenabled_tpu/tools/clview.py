"""clview equivalent: list devices/mesh with capabilities
(lib/clview.cc:43-246 prints platform ids, clock, compute units, workgroup
limits, fp64/FMA/SVM — here: platform, device kind, process, memory)."""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(description="device info (clview)")
    ap.add_argument("--cpu", action="store_true", help="show CPU backend view")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from clenabled_tpu.runtime.device import device_info, get_context

    infos = device_info()
    print(f"Devices: {len(infos)}")
    for i in infos:
        line = (f"  [{i['id']}] {i['platform']}  kind={i['device_kind']}  "
                f"process={i['process_index']}")
        if i.get("bytes_limit"):
            line += f"  memory={i['bytes_limit'] / 2**30:.1f}GiB"
        print(line)
    ctx = get_context()
    print(f"Default mesh: {dict(ctx.mesh.shape)} on platform {ctx.platform}")


if __name__ == "__main__":
    main()
