# Copied from av1tpu/tui/main.py.
"""TUI entry: curses event loop (ref: cmd/av1top/main.go + tui Elm loop).

1 Hz tick reloads the jobs dir + metrics (update.go:57-63); keys: q /
Ctrl-C quit, r force refresh (update.go:84-99).  Run:
  python -m av1tpu_torch.tui.main [config.json] [--once]
"""

from __future__ import annotations

import curses
import sys
import time

from av1tpu_torch import config as config_mod
from av1tpu_torch.tui.model import Model
from av1tpu_torch.tui import view


def _loop(stdscr, model: Model) -> None:
    curses.curs_set(0)
    stdscr.nodelay(True)
    stdscr.timeout(200)
    last_tick = 0.0
    while True:
        now = time.time()
        if now - last_tick >= 1.0:  # 1 Hz tick (model.go:44-48)
            model.refresh()
            last_tick = now
            h, w = stdscr.getmaxyx()
            stdscr.erase()
            for i, line in enumerate(view.render(model, width=w - 1)):
                if i >= h - 1:
                    break
                try:
                    stdscr.addnstr(i, 0, line, w - 1)
                except curses.error:
                    pass
            stdscr.refresh()
        try:
            key = stdscr.getch()
        except curses.error:
            key = -1
        if key in (ord("q"), 3):  # q / ctrl-c
            return
        if key == ord("r"):
            last_tick = 0.0  # force refresh next loop


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    once = "--once" in argv
    argv = [a for a in argv if a != "--once"]
    config_path = argv[0] if argv else config_mod.CONFIG_PATH
    cfg = config_mod.load_config_or_default(config_path)
    model = Model(jobs_dir=cfg.job_state_dir)
    if once:  # one-shot snapshot to stdout (scripting/ops surface)
        model.refresh()
        print("\n".join(view.render(model)))
        return 0
    try:
        curses.wrapper(_loop, model)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
