"""Example: inspect the port's production-mesh dry run of one (arch x
shape), the twin of examples/dryrun_one.py.

Shows the public dry-run API: place the abstract case on the production
mesh (meta DTensors over a ``fake`` process group of 256 or 512 ranks),
trace one step and read the roofline terms, whose compute and memory come
from the analytic model at the H100's peaks and whose collective term
prices the counted bytes at NVLink and NDR rates: modelled, not measured.

  PYTHONPATH=src python examples/dryrun_one_torch.py --arch rwkv6-3b \\
      --shape decode_32k [--multi-pod] [--device cpu]
"""
import argparse
import os
import tempfile


def main() -> None:
    from repro_torch.launch import dryrun

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the mesh's device type (the tensors are meta)")
    args = ap.parse_args()

    rec = dryrun.run_case(args.arch, args.shape, args.multi_pod,
                          out_dir=os.path.join(tempfile.gettempdir(),
                                               "dryrun_torch_example"),
                          device=args.device)
    roof = rec["roofline"]
    print(f"\n{args.arch} x {args.shape} on "
          f"{'2x16x16' if args.multi_pod else '16x16'} mesh:")
    print(f"  trace: {rec['trace_s']}s; argument bytes a rank: "
          f"{rec['argument_bytes'] / 1e6:.1f}MB")
    print(f"  roofline (modelled): compute {roof['t_compute_s']:.3e}s | "
          f"memory {roof['t_memory_s']:.3e}s | "
          f"collective {roof['t_collective_s']:.3e}s")
    print(f"  dominant: {roof['dominant']}; useful flops "
          f"{roof['useful_flops_frac']:.2f}")
    print(f"  collectives: { {k: f'{v/1e9:.2f}GB' for k, v in roof['collective_bytes'].items()} }")


if __name__ == "__main__":
    main()
