"""Command-line interface: fit, evaluate and recommend from the shell.

    python -m rsparse_tpu_torch fit --data ratings.csv --model wrmf \
        --rank 32 --out ckpt/ --eval-holdout 0.2
    python -m rsparse_tpu_torch recommend --checkpoint ckpt/ \
        --data ratings.csv -k 10

Port of ``rsparse_tpu/cli.py``: the same subcommands, flags, defaults and
output (``fit`` prints one JSON line; ``recommend`` one per user), plus
``--device`` (default "cuda"), which goes to the model and to
``checkpoint.load``.  There is no fallback to the CPU: without a CUDA
device, ``--device cuda`` fails with a message.  The checkpoints are the
JAX package's format, so either CLI's ``recommend`` reads the other's
``fit --out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _device(name: str):
    """The torch device ``name``, or None after a message when it is a CUDA
    device and none is available."""
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {name}: no CUDA device is available (pass "
              "--device cpu to run on the CPU)", file=sys.stderr)
        return None
    return device


def _load_data(args):
    import rsparse_tpu_torch as rt
    from .data.io import load_interactions
    t0 = time.perf_counter()
    if args.data == "movielens100k":
        x, parser = rt.load_movielens100k(), "RData"
    else:
        x = load_interactions(args.data, sep=args.sep)
        parser = x.parser
    print(f"data: {x.shape} nnz={x.nnz} ({parser} parser, "
          f"{time.perf_counter() - t0:.2f} s)", file=sys.stderr)
    return x


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fit(args) -> int:
    import rsparse_tpu_torch as rt
    from .utils import checkpoint
    from .utils.profiling import trace

    device = _device(args.device)
    if device is None:
        return 2
    x = _load_data(args)
    test = None
    if args.eval_holdout > 0:
        rng = np.random.default_rng(args.seed)
        x, test = rt.train_test_split(x, args.eval_holdout, rng)

    if args.model == "wrmf":
        model = rt.WRMF(rank=args.rank, lambda_=args.lambda_,
                        feedback=args.feedback, solver=args.solver,
                        precision=args.precision, seed=args.seed,
                        device=device)
    elif args.model == "puresvd":
        model = rt.PureSVD(rank=args.rank, lambda_=args.lambda_,
                           precision=args.precision, seed=args.seed,
                           device=device)
    else:
        model = rt.LinearFlow(rank=args.rank, lambda_=args.lambda_,
                              precision=args.precision, seed=args.seed,
                              device=device)

    t0 = time.time()
    with trace(args.profile_dir, cuda=device.type == "cuda"):
        model.fit_transform(x, n_iter=args.n_iter)
        _sync(device)
    fit_s = time.time() - t0
    print(f"fit: {fit_s:.1f}s", file=sys.stderr)

    result = {"model": args.model, "rank": args.rank, "fit_seconds": fit_s}
    if test is not None:
        preds = model.predict(x, k=args.k, not_recommend=x)
        result["ndcg@k"] = float(np.nanmean(rt.ndcg_k(preds.indices, test)))
        result["map@k"] = float(np.nanmean(rt.ap_k(preds.indices, test)))
    if args.out:
        checkpoint.save(model, args.out)
        result["checkpoint"] = args.out
    print(json.dumps(result))
    return 0


def _recommend(args) -> int:
    from .utils import checkpoint

    device = _device(args.device)
    if device is None:
        return 2
    model = checkpoint.load(args.checkpoint, device=device)
    x = _load_data(args)
    preds = model.predict(x, k=args.k, not_recommend=x)
    ids = preds.ids if preds.ids is not None else preds.indices
    for u in range(min(len(ids), args.limit)):
        uid = preds.user_ids[u] if preds.user_ids else u
        print(json.dumps({"user": str(uid),
                          "items": [str(i) for i in ids[u]],
                          "scores": [round(float(s), 4)
                                     for s in preds.scores[u]]}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rsparse_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fit", help="fit a model")
    f.add_argument("--data", required=True,
                   help="CSV path or 'movielens100k'")
    f.add_argument("--sep", default=",")
    f.add_argument("--model", default="wrmf",
                   choices=["wrmf", "puresvd", "linearflow"])
    f.add_argument("--rank", type=int, default=32)
    f.add_argument("--lambda", dest="lambda_", type=float, default=0.1)
    f.add_argument("--feedback", default="implicit",
                   choices=["implicit", "explicit"])
    f.add_argument("--solver", default="conjugate_gradient",
                   choices=["conjugate_gradient", "cholesky", "nnls"])
    f.add_argument("--precision", default="float32")
    f.add_argument("--n-iter", type=int, default=10)
    f.add_argument("--eval-holdout", type=float, default=0.0)
    f.add_argument("-k", type=int, default=10)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--out", default=None, help="checkpoint directory")
    f.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace here")
    f.add_argument("--device", default="cuda",
                   help="torch device of the model (default cuda)")
    f.set_defaults(fn=_fit)

    r = sub.add_parser("recommend", help="top-k from a checkpoint")
    r.add_argument("--checkpoint", required=True)
    r.add_argument("--data", required=True)
    r.add_argument("--sep", default=",")
    r.add_argument("-k", type=int, default=10)
    r.add_argument("--limit", type=int, default=10)
    r.add_argument("--device", default="cuda",
                   help="torch device to load the model on (default cuda)")
    r.set_defaults(fn=_recommend)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
