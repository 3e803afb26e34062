"""Global tiler configuration singleton.

Parity: TilerConfig (schwarzwald/core/util/Config.{h,cpp}): root directory,
journaling toggle and journal directory, set once by the process layer.
"""
from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class TilerConfig:
    root_directory: str = "."
    is_journaling_enabled: bool = False
    journal_directory: str = "."


_config = TilerConfig()


def global_config() -> TilerConfig:
    return _config


def configure(root_directory: str, journaling: bool) -> None:
    _config.root_directory = root_directory
    _config.is_journaling_enabled = journaling
    _config.journal_directory = os.path.join(root_directory, "journal")
    if journaling:
        os.makedirs(_config.journal_directory, exist_ok=True)
