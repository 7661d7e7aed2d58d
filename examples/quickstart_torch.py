"""Quickstart of the PyTorch/CUDA port: the paper's model end to end.

The twin of ``examples/quickstart.py``: builds MobiRNN's 2-layer x
32-hidden stacked LSTM, runs it under the five execution plans
(sequential, wavefront, the per-cell fused CUDA kernel, the
sequence-resident CUDA kernel -- one launch for the whole sequence -- and
its int8-weight variant), checks that they agree (the int8 plan within its
band), counts the kernel launches of each fused plan with the wrappers'
counters, trains the model briefly on the synthetic HAR data and shows the
load-aware scheduler choosing a backend -- the whole paper in miniature.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

The default device is ``cuda``; without a card that raises.  On the CPU
every plan runs the kernels' plain versions and no launch is counted.
"""
import argparse

import torch

from repro_torch.configs.mobirnn_lstm import CONFIG
from repro_torch.core import lstm, wavefront
from repro_torch.core.scheduler import (Plan, ProcLoadSensor, Scheduler,
                                        SyntheticLoadSensor)
from repro_torch.data import har
from repro_torch.kernels import lstm_cell, lstm_seq
from repro_torch.launch.classify import resolve_device
from repro_torch.launch.train_har import train_step
from repro_torch.optim.adamw import AdamW


def launches(fn, *args) -> dict[str, int]:
    """The kernel launches of one call of ``fn`` (CPU calls count none)."""
    counted = (lstm_cell.lstm_cell, lstm_seq.lstm_seq, lstm_seq.lstm_seq_q8)
    for c in counted:
        c.launches = 0
    fn(*args)
    return {c.__name__: c.launches for c in counted}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=40,
                    help="training steps of the brief HAR run")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = CONFIG
    print(f"model: {cfg.n_layers} layers x {cfg.hidden} hidden "
          f"(paper default) on {device}")
    model = lstm.LSTMClassifier(
        cfg, generator=torch.Generator().manual_seed(0)).to(device)
    params = model.params()
    x = torch.randn(4, cfg.seq_len, cfg.input_dim,
                    generator=torch.Generator().manual_seed(1)).to(device)

    # --- five execution plans, one result ---------------------------------
    with torch.inference_mode():
        seq = lstm.forward_sequential(params, x, cfg)
        wave = lstm.forward_wavefront(params, x, cfg)
        fused_seq = lstm.forward_fused_seq(params, x, cfg)
        fused_q8 = lstm.forward_fused_seq_q8(params, x, cfg)
        fused = lstm.forward_fused_kernel(params, x[:, :16], cfg)
        agree = {
            "wavefront": bool(torch.allclose(seq, wave, atol=1e-4)),
            "fused_seq": bool(torch.allclose(seq, fused_seq, atol=1e-4)),
            "fused_seq_q8": bool(torch.allclose(seq, fused_q8, atol=5e-2)),
        }
        print("wavefront == sequential:", agree["wavefront"])
        print("fused_seq == sequential:", agree["fused_seq"])
        print("fused_seq_q8 within int8 band:", agree["fused_seq_q8"])
        print(f"wavefront width: {wavefront.wavefront_width(cfg.n_layers, 4)}"
              f" -> {wavefront.live_buffers(cfg.n_layers, 4)} preallocated "
              "buffers (paper Fig 1: 6 instead of 24)")
        counts = {name: launches(fn, params, x, cfg) for name, fn in (
            ("fused_seq", lstm.forward_fused_seq),
            ("fused_seq_q8", lstm.forward_fused_seq_q8),
            ("fused_cell", lstm.forward_fused_kernel))}
    del fused
    print(f"kernel launches for T={cfg.seq_len}: fused_seq "
          f"{counts['fused_seq']['lstm_seq']}, fused_seq_q8 "
          f"{counts['fused_seq_q8']['lstm_seq_q8']}, per-cell plan "
          f"{counts['fused_cell']['lstm_cell']} "
          f"(T x L = {cfg.seq_len * cfg.n_layers})"
          + (" -- the CPU runs the plain versions and counts none"
             if device.type == "cpu" else ""))

    # --- brief training on HAR through the sequence-resident plan ---------
    train, test = har.make_har(n_train=512, n_test=256)
    opt = AdamW(lr=3e-3, weight_decay=0.0)
    state = opt.init(params)
    it = har.batches(train, 64)
    losses = []
    for i in range(args.steps):
        bx, by = next(it)
        state, loss, _ = train_step(
            params, state, torch.from_numpy(bx).to(device),
            torch.from_numpy(by).to(device=device, dtype=torch.long), cfg,
            lstm.forward_fused_seq, opt)
        losses.append(float(loss))
        if i % 10 == 0:
            print(f"  step {i:3d} loss {losses[-1]:.3f}")
    with torch.inference_mode():
        acc = float(lstm.accuracy(
            params, torch.from_numpy(test.x).to(device),
            torch.from_numpy(test.y).to(device=device, dtype=torch.long),
            cfg))
    print(f"test accuracy: {acc:.1%} (chance = 16.7%)")

    # --- load-aware dispatch (paper Fig 7) --------------------------------
    # the accelerator plans contend with the sensed load; the CPU plan runs
    # a host copy of the model and does not
    cpu_params = {"layers": [{k: v.detach().cpu() for k, v in p.items()}
                             for p in params["layers"]],
                  "head": {k: v.detach().cpu()
                           for k, v in params["head"].items()}}
    x_cpu = x.cpu()
    sensor = SyntheticLoadSensor(0.0)
    sched = Scheduler(sensor)
    sched.register(Plan("accel/wavefront",
                        lambda p, x: lstm.forward_wavefront(p, x, cfg)))
    sched.register(Plan("accel/fused_seq",
                        lambda p, x: lstm.forward_fused_seq(p, x, cfg)))
    sched.register(Plan("cpu/sequential",
                        lambda p, x: lstm.forward_sequential(
                            cpu_params, x_cpu, cfg), shared=False))
    with torch.inference_mode():
        sched.calibrate(params, x)
        chosen = {}
        for load in (0.1, 0.9):
            sensor.value = load
            _, decision = sched.run(params, x)
            chosen[load] = decision.plan
            print(f"load={load:.0%}: dispatched to {decision.plan}")
    host = ProcLoadSensor().load()
    print(f"this host's load now (ProcLoadSensor, 1-minute loadavg per "
          f"CPU): {host:.2f}; {len(sched.decisions)} decisions kept")
    return {"agree": agree, "launches": counts, "losses": losses,
            "accuracy": acc, "chosen": chosen}


if __name__ == "__main__":
    main()
