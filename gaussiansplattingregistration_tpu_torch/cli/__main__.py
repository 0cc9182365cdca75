"""`python -m gaussiansplattingregistration_tpu_torch.cli` entry point."""

from gaussiansplattingregistration_tpu_torch.cli.main import main

main()
