"""HPO experiment runner (reference experiment_nni.py equivalent): the
port's counterpart of ``dasemanticsegmentationaml_tpu/hpo/experiment.py``
(``run_experiment`` :66-191, ``main`` :194-226), whose trials are the
port's (``python -m dasemanticsegmentationaml_tpu_torch.hpo.trial``, on
the card unless ``--cuda cpu`` is forwarded).

With nni installed: configures a local NNI experiment (Anneal tuner,
maximize mIoU, max 10 trials / concurrency 1 / 12h -- reference
experiment_nni.py:124-143), with the reference's bugs fixed:
  * --aug_type IS forwarded to trials (the reference omits it, so its NNI
    trials silently trained unaugmented -- experiment_nni.py:130-136;
    SURVEY.md section 4 bug 9);
  * trial failures are surfaced instead of swallowed by a bare
    ``except: pass`` port scan (experiment_nni.py:146-152).

Without nni: a built-in runner with the AnnealTuner fallback
drives trials in subprocesses (the same process-isolation boundary NNI
uses), honoring ``concurrency`` with a bounded in-flight pool, and records
intermediate/final mIoU to a JSONL results file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from .search import SEARCH_SPACE, AnnealTuner


def _nni_available() -> bool:
    try:
        import nni  # noqa: F401

        return True
    except ImportError:
        return False


def _trial_command(args_list: List[str]) -> List[str]:
    return [sys.executable, "-m",
            "dasemanticsegmentationaml_tpu_torch.hpo.trial"] + args_list


def build_nni_experiment_config(static_args: Optional[List[str]] = None,
                                max_trials: int = 10, concurrency: int = 1,
                                max_hours: float = 12.0,
                                code_dir: Optional[str] = None) -> Dict:
    """Pure construction of the NNI Experiment settings (reference
    experiment_nni.py:117-143) — unit-testable without nni installed.

    Notably includes every forwarded trial flag (the reference's
    trial_command drops --aug_type, experiment_nni.py:130-136)."""
    return {
        "trial_command": " ".join(_trial_command(list(static_args or []))),
        "trial_code_directory": code_dir or os.getcwd(),
        "search_space": SEARCH_SPACE,
        "tuner_name": "Anneal",
        "tuner_class_args": {"optimize_mode": "maximize"},
        "max_trial_number": max_trials,
        "trial_concurrency": concurrency,
        "max_experiment_duration": f"{max_hours}h",
        "ports": list(range(8030, 8090)),  # reference's scan range
    }


def run_experiment(static_args: Optional[List[str]] = None,
                   max_trials: int = 10, concurrency: int = 1,
                   max_hours: float = 12.0, seed: int = 0,
                   results_path: str = "./nni_results.jsonl",
                   use_nni: Optional[bool] = None) -> Dict:
    """Run the HPO sweep; returns {'best_params', 'best_miou', 'trials'}."""
    static_args = list(static_args or [])
    if use_nni is None:
        use_nni = _nni_available()

    cfg = build_nni_experiment_config(static_args, max_trials, concurrency,
                                      max_hours)
    if use_nni:
        from nni.experiment import Experiment

        exp = Experiment("local")
        exp.config.trial_command = cfg["trial_command"]
        exp.config.trial_code_directory = cfg["trial_code_directory"]
        exp.config.search_space = cfg["search_space"]
        exp.config.tuner.name = cfg["tuner_name"]
        exp.config.tuner.class_args = cfg["tuner_class_args"]
        exp.config.max_trial_number = cfg["max_trial_number"]
        exp.config.trial_concurrency = cfg["trial_concurrency"]
        exp.config.max_experiment_duration = cfg["max_experiment_duration"]
        last_err = None
        for port in cfg["ports"]:
            try:
                exp.run(port)
                return {"nni": True, "port": port}
            except Exception as e:  # surface, don't swallow silently
                last_err = e
        raise RuntimeError(f"no free NNI port in 8030-8089: {last_err}")

    # ---- built-in fallback runner ----------------------------------------
    # Honors ``concurrency`` for real: up to that many trial subprocesses
    # in flight at once (like NNI's trial_concurrency); each completion
    # feeds the tuner and frees a slot. Each trial is a process of its own
    # on the card its flags name (--cuda, cuda:0 by default): at
    # concurrency > 1 the trials time-share that one H100 (its memory and
    # its streams), none waits for another.
    from concurrent.futures import (FIRST_COMPLETED, ThreadPoolExecutor,
                                    wait)

    # budget caps the random-init phase: at the reference's default 10
    # trials a fixed init_random=10 would consume the whole sweep and
    # never anneal
    tuner = AnnealTuner(seed=seed, budget=max_trials)
    deadline = time.time() + max_hours * 3600
    trials = []
    os.makedirs(os.path.dirname(os.path.abspath(results_path)),
                exist_ok=True)

    def run_trial(trial_id, params):
        out_path = f"{results_path}.trial{trial_id}"
        cmd = _trial_command(static_args + [
            "--nni_params", json.dumps(params),
            "--nni_output", out_path,
        ])
        # Per-trial timeout derived from the experiment deadline: without
        # it one wedged trial runs forever and defeats the max_hours cap
        # the reference had (its NNI daemon enforced the cap; a bare
        # subprocess.run does not). subprocess.run kills the child on
        # expiry; the trial is recorded as timed out and the sweep moves
        # on.
        remaining = deadline - time.time()
        if remaining <= 0:
            return params, 0.0, None, True
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=remaining)
        except subprocess.TimeoutExpired:
            return params, 0.0, None, True
        miou = 0.0
        if proc.returncode == 0 and os.path.exists(out_path):
            with open(out_path) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec.get("type") == "final":
                        miou = float(rec["value"])
        return params, miou, proc, False

    concurrency = max(1, int(concurrency))
    with ThreadPoolExecutor(max_workers=concurrency) as ex:
        pending = {}
        next_id = 0
        while next_id < max_trials or pending:
            while (next_id < max_trials and len(pending) < concurrency
                   and time.time() <= deadline):
                params = tuner.generate_parameters()
                fut = ex.submit(run_trial, next_id, params)
                pending[fut] = (next_id, params)
                next_id += 1
            if not pending:
                break
            done, _ = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                trial_id, params = pending.pop(fut)
                timed_out = False
                try:
                    _, miou, proc, timed_out = fut.result()
                    if timed_out:
                        print(f"trial {trial_id} timed out (experiment "
                              "deadline); killed and recorded",
                              file=sys.stderr)
                    elif proc.returncode != 0:
                        print(f"trial {trial_id} failed:\n"
                              f"{proc.stderr[-2000:]}", file=sys.stderr)
                except Exception as e:
                    # e.g. a truncated --nni_output JSON from a killed
                    # subprocess; degrade like a failed trial instead of
                    # aborting the sweep and losing in-flight results
                    print(f"trial {trial_id} errored: {e!r}",
                          file=sys.stderr)
                    miou = 0.0
                tuner.receive_trial_result(params, miou)
                trials.append({"id": trial_id, "params": params,
                               "miou": miou, "timed_out": timed_out})
                with open(results_path, "a") as f:
                    f.write(json.dumps(trials[-1]) + "\n")

    best = tuner.best
    return {
        "nni": False,
        "trials": trials,
        "best_params": best[0] if best else None,
        "best_miou": best[1] if best else None,
    }


def main(argv=None):
    """CLI (reference experiment_nni.py equivalent):

    python -m dasemanticsegmentationaml_tpu_torch.hpo.experiment \
        --max_trials 10 -- --root_source ... --root_target ... --root ...

    Everything after ``--`` is forwarded verbatim to every trial
    (including --aug_type, which the reference silently dropped).
    """
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--max_trials", type=int, default=10)
    p.add_argument("--concurrency", type=int, default=1)
    p.add_argument("--max_hours", type=float, default=12.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--results_path", type=str, default="./nni_results.jsonl")
    p.add_argument("--use_nni", action="store_true",
                   help="force the real NNI daemon (default: auto-detect)")
    p.add_argument("trial_args", nargs="*",
                   help="args after -- forwarded to each trial")
    args = p.parse_args(argv)
    result = run_experiment(
        static_args=args.trial_args, max_trials=args.max_trials,
        concurrency=args.concurrency, max_hours=args.max_hours,
        seed=args.seed, results_path=args.results_path,
        use_nni=args.use_nni or None)
    print(json.dumps({k: v for k, v in result.items() if k != "trials"}))
    return result


if __name__ == "__main__":
    main()
