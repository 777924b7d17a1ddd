#!/usr/bin/env python3
"""chip_smoke.py's cluster phases alone, on one NVIDIA GPU:

    python3 tools/phase.py NAME... [--readings] [--checkout PATH]

NAME is ``cluster``, ``tracing``, ``deployment``, ``data``,
``operations``, ``jobs``, ``tune``, ``collective``, ``trainer``,
``parallel`` or ``rllib``: each runs chip_smoke.py's ``NAME_phase`` of
PATH's checkout (default: this one), in the order given, after building
the checkout's kernels.  cluster: a Llama-3-8B actor in a cluster of two
GCS replicas and a node daemon, answering beside an engine in this
process, through compiled DAGs over shared-memory channels (CUDA
tensors both ways), across a GCS restart and a leader failover,
streaming its greedy token ids, and a task's CUDA tensor rebuilt from
its lineage (this process makes the 8B weights and the engine first);
tracing: a
traced Llama-3-8B request through an actor in cluster mode;
deployment: build_llm_deployment serving Llama-3-8B from three
replicas; data: build_llm_processor generating from Llama-3-8B in two
actors, build_logprob_processor scoring through the device feed, and
list-block Data at a million rows; operations: a Llama-3-8B actor in a
placement group, watched through the dashboard, the node agent's card
gauges, the CPU profiler, the state API and the CLI, with lockcheck's
instrumented locks in every process; jobs: a job
submitted through the dashboard that drives a Llama-3-8B actor from
outside the cluster through the client (``art://``) under a runtime env,
a stopped job, export events and a task in a pip venv launching the sm90
forward (after ``operations`` it reuses that phase's reference tokens,
alone it builds them once); tune: an ASHA learning-rate sweep of four
llama-400m trials on a GPU node that the port's autoscaler launches for
them and removes after; collective: an NCCL group at world size 1,
every verb, the fused allreduce of llama-400m's parameter shapes, the
int8 transport and the ready-hook GradientSyncer against plain torch;
trainer: a TorchTrainer of two llama-400m ranks sharing the card,
gradients averaged every step over gloo, a checkpoint loaded back;
parallel: a tensor-parallel Llama-3-8B engine on a virtual mesh of two
cells of the card against the unsharded model, then a sharded llama-400m
step (fsdp=2, tp=2) with its gradients, ring attention at sp=2 and
GPipe at pp=2 against the unsharded loss (alone it makes both models'
weights from seed 0, and an unsharded engine's tokens as the serving
slice's); rllib: PPO learning CartPole-v1 in this process (runners
inline, no cluster) at the reference's learning configuration, then one
update of PPO, IMPALA, APPO, DQN, SAC and BC on the card against the
CPU.
Random weights from seed 0, gates included.  ``--readings`` is for
phases that take it: in data the NLL gate is left out, every other gate
stays, and faults planted in blockwise attention are read beside the
sound reading, which is what ``DATA_NLL_TOL`` is set from; in parallel
the TP logits gate is left out and faults planted in the TP prefill
(wq's or wo's shards swapped between the cells, the psum dropped) and
the unsharded model's own spread are read, which is what
``TP_BF16_LOGIT_TOL`` is set from, and the tp=2 llama-400m logits in
fp32 and bf16 (ROADMAP C4) are printed ungated, which is what
``TP_LOGIT_TOL`` is set from.

Prints the card's nvidia-smi line, the Python, torch and CUDA versions
and which optional packages are installed, then each phase's lines and
its launches; exits non-zero if a gate fails (a cluster phase prints
its workers' logs first).
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("cluster", "tracing", "deployment", "data", "operations", "jobs",
          "tune", "collective", "trainer", "parallel", "rllib")
OPTIONAL = ("aiohttp", "grpc", "transformers", "pyarrow", "pandas")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="+", choices=PHASES)
    parser.add_argument("--readings", action="store_true")
    parser.add_argument("--checkout", default=ROOT)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.checkout))
    import torch

    if not torch.cuda.is_available():
        print("phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke  # noqa: PLC0415
    from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: PLC0415
    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import _build  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    os.environ["HF_HUB_OFFLINE"] = os.environ["TRANSFORMERS_OFFLINE"] = "1"
    os.environ["ART_DISABLE_GCE_METADATA"] = "1"     # as chip_smoke's main
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, f"checkout {os.path.abspath(args.checkout)}",
          sys.version.split()[0], torch.__version__, torch.version.cuda,
          {m: importlib.util.find_spec(m) is not None for m in OPTIONAL},
          flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    kept = {}   # the operations phase's reference tokens, for jobs
    for name in args.names:
        phase = getattr(chip_smoke, f"{name}_phase")
        params = inspect.signature(phase).parameters
        kwargs = ({"readings": True} if args.readings and "readings" in
                  params else {})
        if "keep" in params:
            kwargs["keep"] = kept
        if "want" in params:
            kwargs["want"] = kept.get("tokens")
        t0 = time.perf_counter()
        if name == "cluster":
            # The runtime phase's engine on the slice's weights (seed 0),
            # warmed as that phase leaves it: the cluster phase holds the
            # card's free memory to its level before the actor starts.
            engine = LLMEngine("llama3-8b", slots=2, max_seq=4096, seed=0)
            for n in chip_smoke.RUNTIME_PROMPTS:
                engine.generate([[1] * n], SamplingParams(
                    max_tokens=chip_smoke.RUNTIME_TOKENS))
            launches = phase(torch, fa, llama, engine.params, engine, card)
            del engine
            torch.cuda.empty_cache()
        elif name == "rllib":
            torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke
            torch.backends.cudnn.allow_tf32 = False
            launches = phase(torch, card)
        else:
            launches = phase(torch, llama, card, **kwargs)
        print(f"{name} phase: {time.perf_counter() - t0:.1f} s, launches "
              f"{launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
