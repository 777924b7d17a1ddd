#!/usr/bin/env python3
"""Which side of a CPU parity comparison moves from run to run: both
sides' loss and gradients of
``tests/test_torch_train.py::test_loss_and_grads_match_jax[impls0-none]``
(the "tiny" Llama at the test's SMALL widths: the port's plain flash
versions against the JAX package's Pallas kernels in interpret mode),
taken once per process and compared across processes.  CPU only:

    JAX_PLATFORMS=cpu python tools/parity_spread.py save DIR \\
        [--one-thread] [--checkout PATH]
    python tools/parity_spread.py summary DIR

``save`` takes one reading of CHECKOUT's port and tests (default: this
repository), with torch and XLA held to one thread under
``--one-thread``, and writes it to a new file in DIR.  To take readings
under the test suite's own settings, load this file as a pytest plugin
beside the test files: every worker that ran a test of
``tests/test_torch_train.py`` then takes one reading at the end of its
session, with the threads and the state the suite left it.

    PARITY_SPREAD_DIR=DIR JAX_PLATFORMS=cpu python -m pytest \\
        -p tools.parity_spread -n 6 --dist loadfile \\
        tests/test_torch_train.py tests/test_torch_gpt2.py ...

``summary`` prints one JSON line: for each side, the leaves whose values
differ between readings and the largest difference; for each leaf, the
least and the most of its error over the test's limit (GRAD_REL_TOL x
max |ref|).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

_ran_train_test = False


def reading(checkout):
    """Both sides' loss and gradient leaves, and each leaf's limit."""
    sys.path[:0] = [checkout, os.path.join(checkout, "tests")]
    import jax  # noqa: PLC0415
    import jax.numpy as jnp  # noqa: PLC0415
    import numpy as np  # noqa: PLC0415
    import torch  # noqa: PLC0415

    import test_torch_train as t  # noqa: PLC0415

    jcfg, tcfg = t._configs("tiny", **t.SMALL)
    jparams, tparams = t._params(jcfg, tcfg, 0)
    tokens = t._tokens(1, 2, 129)
    loss_j, grads_j = jax.value_and_grad(t.jl.loss_fn)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, jcfg,
        attn_impl="pallas", remat="none")
    flat = t._flat(tparams)
    for _, leaf in flat:
        leaf.requires_grad_()
    loss_t = t.tl.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)},
                          tcfg, attn_impl="flash", remat="none")
    grads_t = torch.autograd.grad(loss_t, [leaf for _, leaf in flat])
    want = dict(t._flat(grads_j))
    out = {"loss:torch": np.float64(loss_t.item()),
           "loss:jax": np.float64(loss_j)}
    for (path, _), got in zip(flat, grads_t):
        ref = np.asarray(want[path])
        out[f"torch:{path}"] = got.numpy()
        out[f"jax:{path}"] = ref
        out[f"limit:{path}"] = np.float64(t.GRAD_REL_TOL
                                          * np.abs(ref).max())
    return out


def save(out_dir, checkout):
    import numpy as np  # noqa: PLC0415

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{time.time_ns()}_{os.getpid()}.npz")
    np.savez(path, **reading(checkout))
    return path


def summary(out_dir):
    import numpy as np  # noqa: PLC0415

    runs = [dict(np.load(f))
            for f in sorted(glob.glob(os.path.join(out_dir, "*.npz")))]
    leaves = sorted(k.split(":", 1)[1] for k in runs[0]
                    if k.startswith("torch:"))
    moved = {}
    for side in ("torch", "jax"):
        diff = {leaf: float(max(np.abs(r[f"{side}:{leaf}"]
                                       - runs[0][f"{side}:{leaf}"]).max()
                                for r in runs))
                for leaf in leaves}
        moved[side] = {leaf: d for leaf, d in diff.items() if d}
    share = {}
    for leaf in leaves:
        ratios = [float(np.abs(r[f"torch:{leaf}"] - r[f"jax:{leaf}"]).max()
                        / r[f"limit:{leaf}"]) for r in runs]
        share[leaf] = [min(ratios), max(ratios)]
    return {"readings": len(runs), "moved": moved,
            "error_over_limit": share}


# ------------------------------------------------------- pytest plugin


def pytest_runtest_logreport(report):
    global _ran_train_test
    # Reports that carry a worker `node` ran in another process (this is
    # pytest-xdist's controller): only the process that ran them reads.
    if (report.when == "call" and getattr(report, "node", None) is None
            and report.nodeid.startswith("tests/test_torch_train.py::")):
        _ran_train_test = True


def pytest_sessionfinish(session):
    out_dir = os.environ.get("PARITY_SPREAD_DIR")
    if out_dir and _ran_train_test:
        save(out_dir, str(session.config.rootpath))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="command", required=True)
    p_save = sub.add_parser("save")
    p_save.add_argument("dir")
    p_save.add_argument("--one-thread", action="store_true")
    p_save.add_argument("--checkout", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    p_sum = sub.add_parser("summary")
    p_sum.add_argument("dir")
    args = parser.parse_args()
    if args.command == "summary":
        print(json.dumps(summary(args.dir)))
        return 0
    # The device count tests/conftest.py sets.
    flags = ["--xla_force_host_platform_device_count=8"]
    if args.one_thread:
        flags += ["--xla_cpu_multi_thread_eigen=false",
                  "intra_op_parallelism_threads=1"]
        import torch  # noqa: PLC0415

        torch.set_num_threads(1)
    os.environ["XLA_FLAGS"] = " ".join(flags)
    print(save(args.dir, os.path.abspath(args.checkout)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
