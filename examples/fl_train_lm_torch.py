"""Federated training of a transformer LM with FedOSAA on the PyTorch/CUDA
port (the port's counterpart of examples/fl_train_lm.py): the reduced
smollm-135m, FedOSAA-SVRG against FedSVRG, through
repro_torch.launch.fl_train with the reference example's preset arguments.

  PYTHONPATH=src python examples/fl_train_lm_torch.py                # on the card
  PYTHONPATH=src python examples/fl_train_lm_torch.py --rounds 5 --device cpu

Each round performs L=5 local steps + 1 AA step per client. Any further
flag of repro_torch.launch.fl_train (``--device``, ``--rounds``,
``--round-chunk``, ``--comm-codec``, ...) is passed through.
"""
import sys

from repro_torch.launch.fl_train import main as fl_train_main

PRESET = ["--arch", "smollm-135m", "--reduced",
          "--algo", "fedosaa_svrg", "--baseline", "fedsvrg"]


def main(argv=None) -> dict:
    """fl_train's results by algorithm."""
    return fl_train_main(PRESET + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
