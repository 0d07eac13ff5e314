"""python -m tggcn_torch.train models=... data=... [overrides] [--device cpu]
(``train/cli.py``)."""

from tggcn_torch.train.cli import main

main()
