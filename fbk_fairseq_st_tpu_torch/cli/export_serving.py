"""``cli/export_serving``: ROADMAP Queue A item 9(c)'s serving half, not
ported yet (``cli/serve.py`` says what stands in its place)."""

from __future__ import annotations

from .serve import NOT_PORTED


def main(args=None):
    raise NotImplementedError(NOT_PORTED.format("cli/export_serving"))


def cli_main(input_args=None):
    return main(input_args)


if __name__ == "__main__":
    cli_main()
