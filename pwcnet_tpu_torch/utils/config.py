"""Experiment config snapshotting and artifact collection.

Re-creates the reference's utils.py surface: `save_config` dumps a dict to
JSON; `ExperimentSaver` snapshots the parsed CLI args to ``config.json`` and
moves run artifacts (figures, checkpoints) into the log directory at the end
of a run; `show_progress` is a lightweight stdout progress line.
"""

from __future__ import annotations

import json
import shutil
import sys
from collections import OrderedDict
from datetime import datetime
from pathlib import Path

__all__ = ["save_config", "ExperimentSaver", "show_progress", "timestamp"]


def timestamp() -> str:
    return datetime.now().strftime("%Y-%m-%d-%H-%M")


def show_progress(epoch, batch, batch_total, width: int = 20, **kwargs) -> None:
    """Single-line progress indicator (reference surface: utils.py:9-14).

    Rewritten with a textual bar + percentage; extra keyword metrics are
    appended as ``key: value`` pairs. Used as the non-tty fallback where
    tqdm would be noisy (evaluate.py) — the Trainer uses tqdm directly.
    """
    total = max(int(batch_total), 1)
    frac = min(max(batch / total, 0.0), 1.0)
    fill = int(round(frac * width))
    bar = "#" * fill + "-" * (width - fill)
    extras = "".join(f", {k}: {v}" for k, v in kwargs.items())
    print(
        f"\r{epoch} epoch: |{bar}| {frac * 100:5.1f}% "
        f"[{batch}/{batch_total}{extras}]",
        end="",
        file=sys.stdout,
        flush=True,
    )


def save_config(config, filename: str | None = None) -> str:
    if not isinstance(config, (dict, OrderedDict)):
        raise TypeError("arg config must be a dict or OrderedDict")
    if filename is None:
        filename = f"config_{timestamp()}.json"
    with open(filename, "w") as f:
        json.dump(OrderedDict(config), f, indent=4, default=str)
    return filename


class ExperimentSaver:
    """Collects run artifacts into a log directory.

    Unlike the reference (utils.py:51-53, which uses Path.rename and fails
    across filesystems), artifacts are moved with shutil.move. A directory
    already in the log directory (a resumed run started within the same
    minute logs to the same ``history_<ts>``) takes the new entries, which
    replace its own of the same name, rather than a nested copy.
    """

    def __init__(self, logdir=None, parse_args=None):
        self.logdir = Path(logdir) if logdir else Path(f"logs_{timestamp()}")
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.save_list: list[Path] = []
        if parse_args is not None:
            save_config(vars(parse_args), "config.json")
            self.append("config.json")

    def append(self, file_or_dir_names) -> None:
        if not isinstance(file_or_dir_names, list):
            file_or_dir_names = [file_or_dir_names]
        self.save_list.extend(Path(n) for n in file_or_dir_names)

    def save(self) -> None:
        for path in self.save_list:
            if path.exists():
                _move(path, self.logdir / path.name)


def _move(src: Path, dst: Path) -> None:
    if src.is_dir() and dst.is_dir():
        for child in src.iterdir():
            _move(child, dst / child.name)
        src.rmdir()
    else:
        shutil.move(str(src), str(dst))
