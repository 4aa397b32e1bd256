"""The command line: ``python -m flownet2_tpu_torch.cli`` (``main.main``)."""

from .main import build_parser, main  # noqa: F401
