"""Operations and bytes of a training step, worked out from shapes:
``arith/<config>.py`` for each configuration, ``arith/embedding.py`` for
the sparse path they share."""
import importlib


def load(config_name: str):
    """The module ``arith/<config_name>.py``."""
    return importlib.import_module(f"perfbench.arith.{config_name}")
