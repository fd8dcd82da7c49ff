"""AVMNIST training entry point (counterpart of `mmtpu/cli/train_avmnist.py`).

    python -m mmtpu_torch.cli.train_avmnist --config X.yaml --run_id N [...]

`train_multimodal` with the AVMNIST nesting of `epoch_metrics.json`: every
pattern-suffixed metric under its pattern key (AI/A/I), and the test entry
written to `<metrics>/<run_id>/epoch_metrics.json`. The same flags, and
the same cross-validation and --stacked-runs drivers.
"""

from __future__ import annotations

import sys

from mmtpu_torch.cli import train_multimodal


def main(argv=None) -> int:
    return train_multimodal.main(argv, json_nesting="avmnist",
                                 module="mmtpu_torch.cli.train_avmnist")


if __name__ == "__main__":
    sys.exit(main())
