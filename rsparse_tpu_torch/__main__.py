"""``python -m rsparse_tpu_torch``: the command-line interface (cli.py)."""

from .cli import main

raise SystemExit(main())
