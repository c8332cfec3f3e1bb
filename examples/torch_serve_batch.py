"""Serve a small model with batched requests on the PyTorch port: prefill +
greedy decode (``examples/serve_batch.py`` on the JAX reference).

    PYTHONPATH=src python examples/torch_serve_batch.py --arch mamba2-2.7b
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu

On the card the prefill's attention is the K11 kernel.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.launch import serve as serve_mod


def run(args, device=None) -> dict:
    """``launch.serve.main``'s numbers for the reduced ``args.arch``: the
    greedy tokens (b, 16), prefill and decode seconds."""
    dev = device if device is not None else args.device
    argv = ["--arch", args.arch, "--reduced", "--batch", str(args.batch),
            "--prompt-len", "32", "--gen", "16"]
    if dev is not None:
        argv += ["--device", str(dev)]
    out = serve_mod.main(argv)
    print("OK: served", out["tokens"].shape, "tokens")
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    run(parse(argv))


if __name__ == "__main__":
    main()
