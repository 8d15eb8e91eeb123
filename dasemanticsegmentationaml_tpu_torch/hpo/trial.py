"""HPO trial entry point (the reference's train_nni.py): one DA run of the
port's CLI with the tuner's hyperparameters.

    python -m dasemanticsegmentationaml_tpu_torch.hpo.trial \
        --nni_params '{"batch_size": 8, "num_epochs": 20}' \
        --nni_output trial.jsonl <the CLI's flags>

Counterpart of ``dasemanticsegmentationaml_tpu/hpo/trial.py`` (main
:86-134), with its rules:
  * the discriminator is always the full FCDiscriminator (``--depthwise
    False``, train_nni.py:68), D consumes the out32 auxiliary head
    (``--d_head 2``, train_nni.py:135) and the update ordering is the
    combined one (``--da_step_mode combined``, train_nni.py:105-163).
    These are appended after the passthrough flags, so that they win
    (JAX :97-102);
  * the hyperparameters (batch_size, lr, lr_D1, num_epochs, lambda_adv1,
    weight_decay) come from ``--nni_params`` or NNI's
    ``get_next_parameter``, the reference's key names mapped onto these
    (JAX :64-83);
  * each validation's mIoU is reported as an intermediate result, then
    the best of them as the final one (train_nni.py:194-195), explicitly
    ``max_miou``, else the final eval's ``miou``, else 0.0 (JAX
    :122-131).

The run is on the card unless the passthrough says ``--cuda cpu``; the
CLI never falls back to the CPU. Under ``--num_devices`` rank 0's reports
reach this process through ``parallel/distributed.py::spawn``, so the
reporter below runs here, once a validation, and NNI's per-trial state
stays in this process.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional


def _nni():
    """The ``nni`` module, or None where it is not installed; imported at
    each report, so that a reporter holds no module and pickles."""
    try:
        import nni
    except ImportError:
        return None
    return nni


class _Reporter:
    """nni.report_* when NNI is installed, and a JSONL record a report in
    ``output`` where given (JAX :32-56). Called as ``report_fn(epoch,
    miou)`` it reports an intermediate result."""

    def __init__(self, output: Optional[str]):
        self.output = output

    def _record(self, kind: str, value: float):
        if self.output:
            with open(self.output, "a") as f:
                f.write(json.dumps({"type": kind, "value": value}) + "\n")

    def intermediate(self, value: float):
        nni = _nni()
        if nni is not None:
            nni.report_intermediate_result(value)
        self._record("intermediate", value)

    def final(self, value: float):
        nni = _nni()
        if nni is not None:
            nni.report_final_result(value)
        self._record("final", value)

    def __call__(self, epoch, miou):
        self.intermediate(float(miou))


# the reference's search-space key names (experiment_nni.py:107-114) map
# onto ours, so a user's existing reference NNI config works unchanged
_REFERENCE_PARAM_ALIASES = {
    "batch-size": "batch_size",
    "learning_rate": "lr",
    "learning_rate_D": "lr_D1",
    "lambda_adv_target1": "lambda_adv1",
}


def get_params(args) -> dict:
    if args.nni_params:
        params = json.loads(args.nni_params)
    else:
        nni = _nni()
        params = nni.get_next_parameter() if nni is not None else {}
    return {_REFERENCE_PARAM_ALIASES.get(k, k): v for k, v in params.items()}


def trial_args(passthrough, params) -> list:
    """The CLI's argv: the passthrough, the trial's forced flags after it
    (JAX :97-102), then the tuner's values (JAX :103-114)."""
    cli_args = list(passthrough) + [
        "--domain_adaptation", "True",
        "--d_head", "2",                 # train_nni.py:135 out32 head
        "--depthwise", "False",          # train_nni.py:68 always FCD
        "--da_step_mode", "combined",    # train_nni.py:116-163 ordering
    ]
    if "batch_size" in params:
        cli_args += ["--batch_size", str(int(params["batch_size"]))]
    if "lr" in params:
        cli_args += ["--learning_rate", str(params["lr"])]
    if "lr_D1" in params:
        cli_args += ["--learning_rate_D", str(params["lr_D1"])]
    if "num_epochs" in params:
        cli_args += ["--num_epochs", str(int(params["num_epochs"]))]
    if "lambda_adv1" in params:
        cli_args += ["--lambda_adv_target1", str(params["lambda_adv1"])]
    if "weight_decay" in params:
        cli_args += ["--weight_decay", str(params["weight_decay"])]
    return cli_args


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--nni_params", type=str, default=None)
    parser.add_argument("--nni_output", type=str, default=None)
    known, passthrough = parser.parse_known_args(argv)

    params = get_params(known)
    reporter = _Reporter(known.nni_output)

    from .. import cli

    # per-validation intermediate reports (train_nni.py:194): the trainer
    # calls back after every validation, so the tuner gets an
    # early-stopping signal, not just one number at the end
    result = cli.main(trial_args(passthrough, params), report_fn=reporter)
    # explicit key checks, NOT an `or` chain: a legitimate max_miou of
    # 0.0 (every validation diverged) is falsy and would fall through to
    # the final-eval miou, a different metric than the reference's
    # max-of-validations (train_nni.py:195)
    if "max_miou" in result:
        miou = float(result["max_miou"])
    elif "miou" in result:
        miou = float(result["miou"])
    else:
        miou = 0.0
    reporter.final(miou)
    return miou


if __name__ == "__main__":
    main()
