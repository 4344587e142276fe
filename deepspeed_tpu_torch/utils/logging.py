"""The port's logger: ``deepspeed_tpu_torch``, INFO and above to stdout.

It propagates to the root logger as well, so an application's own
handlers (and pytest's ``caplog``) see its records."""

import logging
import sys

logger = logging.getLogger("deepspeed_tpu_torch")
if not logger.handlers:
    _handler = logging.StreamHandler(stream=sys.stdout)
    _handler.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)
