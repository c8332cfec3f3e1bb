"""Train an assigned-architecture LM on the PyTorch port with the FDA head
active (eq. 12 on the client = data-shard axis), asserting the loss
decreases (``examples/train_lm.py`` on the JAX reference).

    PYTHONPATH=src python examples/torch_train_lm.py --device cpu    # reduced
    PYTHONPATH=src python examples/torch_train_lm.py --arch smollm-135m --full

The reduced default is the smoke-scale config; ``--full`` trains the real
config at its published width on the CUDA card (attention's forward and
backward are the K11 and K11b kernels).
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.launch import train as train_mod


def run(args, device=None) -> dict:
    """``launch.train.main``'s numbers: the loss of every step, the first-10
    and last-10 means and every step's gradient norm before clipping."""
    dev = device if device is not None else args.device
    argv = ["--arch", args.arch, "--steps", str(args.steps), "--batch", "8",
            "--seq", "128", "--clients", "2", "--log-every", "25"]
    if not args.full:
        argv.append("--reduced")
    if dev is not None:
        argv += ["--device", str(dev)]
    return train_mod.main(argv)


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    out = run(parse(argv))
    assert out["last"] < out["first"], "loss must decrease"
    print("OK: loss decreased", f"{out['first']:.3f} -> {out['last']:.3f}")


if __name__ == "__main__":
    main()
