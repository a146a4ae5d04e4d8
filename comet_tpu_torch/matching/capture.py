"""Stdout/stderr capture for experiment runs.

Counterpart of ``comet_tpu/matching/capture.py`` (gluefactory's
``utils/stdout_capturing.py``): ``match --train --exp-dir`` tees its output
to ``<exp_dir>/log.txt`` and rewrites terminal control characters so
progress bars collapse to their final line. Everything that prints is
Python, so a ``sys.stdout`` / ``sys.stderr`` tee is exact.
"""

from __future__ import annotations

import sys
from contextlib import contextmanager
from pathlib import Path


def apply_backspaces_and_linefeeds(text: str) -> str:
    """Interpret ``\\b`` and ``\\r`` like a terminal, line by line.

    Same semantics as the reference implementation
    (stdout_capturing.py:17-52): a carriage return moves the cursor to
    column 0 (unless it is the very last character, which is kept so the
    chunk stays concatenable), backspace moves it left, and later writes
    overwrite earlier characters — so tqdm-style progress bars keep only
    their final state in the captured log.
    """
    orig_lines = text.split("\n")
    n_lines = len(orig_lines)
    new_lines = []
    for li, line in enumerate(orig_lines):
        chars, cursor = [], 0
        n = len(line)
        for ci, ch in enumerate(line):
            last = ci == n - 1 and li == n_lines - 1
            if ch == "\r" and not last:
                cursor = 0
            elif ch == "\b":
                cursor = max(0, cursor - 1)
            else:
                if ch == "\r" and last:
                    cursor = len(chars)
                if cursor == len(chars):
                    chars.append(ch)
                else:
                    chars[cursor] = ch
                cursor += 1
        new_lines.append("".join(chars))
    return "\n".join(new_lines)


class _Tee:
    """Write-through stream: forwards to the original stream and a file.

    Only the text-level API (write/writelines/flush) is teed; writes that
    bypass it — ``sys.stdout.buffer.write`` or raw fd writes from
    subprocesses/C extensions — fall through ``__getattr__`` to the
    original stream and reach the terminal but not the log file (same
    limitation as the reference's sys.stdout-swap tee).
    """

    def __init__(self, stream, fh):
        self._stream = stream
        self._fh = fh

    def write(self, data):
        self._stream.write(data)
        self._fh.write(data)
        return len(data)

    def writelines(self, lines):
        for line in lines:
            self.write(line)

    def flush(self):
        self._stream.flush()
        self._fh.flush()

    def isatty(self):
        return False

    def __getattr__(self, name):  # encoding, errors, fileno passthrough
        return getattr(self._stream, name)


@contextmanager
def capture_outputs(filename):
    """Tee stdout+stderr to ``filename`` for the duration of the block.

    On exit the raw capture is rewritten through
    :func:`apply_backspaces_and_linefeeds` (the reference does the same in
    its ``tee_output`` finally-block, stdout_capturing.py:120-134), so the
    saved log reads like the final terminal screen.
    """
    path = Path(filename)
    path.parent.mkdir(parents=True, exist_ok=True)
    out, err = sys.stdout, sys.stderr
    with open(path, "a", encoding="utf-8", errors="replace") as fh:
        sys.stdout, sys.stderr = _Tee(out, fh), _Tee(err, fh)
        try:
            yield
        finally:
            sys.stdout, sys.stderr = out, err
    # newline="" so raw \r survives the read (universal-newline mode would
    # pre-translate it and defeat the terminal interpretation)
    with open(path, "r", encoding="utf-8", errors="replace", newline="") as fh:
        raw = fh.read()
    path.write_text(apply_backspaces_and_linefeeds(raw), encoding="utf-8")
