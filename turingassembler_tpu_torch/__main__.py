"""`python -m turingassembler_tpu_torch <command> ...`: see cli.py."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
