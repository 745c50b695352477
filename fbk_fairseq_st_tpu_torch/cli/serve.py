"""The serving CLIs' place in the port.

JAX's ``cli/serve.py`` (a batching JSON-over-HTTP front end) and
``cli/export_serving.py`` (a checkpoint compiled ahead of time into a
serving artifact), with ``serving/`` and the hub (``hub_utils.py``,
``hubconf.py``), are ROADMAP Queue A item 9(c)'s serving half, which the
port has not yet: each entry point raises ``NotImplementedError`` naming
it. Serve a checkpoint with ``cli/generate`` or ``cli/interactive`` (with
``--quantize-weights int8``) meanwhile.
"""

from __future__ import annotations

NOT_PORTED = ("{}: the serving half of ROADMAP Queue A item 9(c) (serving/, cli/serve, cli/export_serving, the hub) "
              "is not ported; serve with cli/generate or cli/interactive (--quantize-weights int8)")


def main(args=None):
    raise NotImplementedError(NOT_PORTED.format("cli/serve"))


def cli_main(input_args=None):
    return main(input_args)


if __name__ == "__main__":
    cli_main()
