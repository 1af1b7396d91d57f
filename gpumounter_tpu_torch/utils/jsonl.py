"""The two crash-safety steps of an fsync'd append-only JSONL journal.

The worker's mount ledger (``worker/ledger.py``) and the master's
write-behind queue (``store/writebehind.py``) both append one JSON object a
line, each line written whole and fsync'd before it is acknowledged. They
share what must happen around that:

  fsync_dir     a file created or renamed into a directory survives a node
                crash only once the directory itself is fsync'd.
  read_records  a last line without its newline is a death in the middle of
                an append: its record was never fsync'd, so never
                acknowledged. The file is cut back to its last newline (and
                fsync'd) before anything is appended again; a torn tail left
                in place would swallow the next record, which would then
                not parse at the following reload, and an acknowledged write
                would be lost.
"""

from __future__ import annotations

import json
import os


def fsync_dir(directory: str) -> None:
    """Make a directory's entries durable (a file created or renamed in it)."""
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def read_records(path: str) -> tuple[list[dict], int]:
    """The file's records and the number of lines dropped: a torn tail,
    which is cut off the file, and any line between that does not parse."""
    with open(path, "r+b") as f:
        data = f.read()
        end = data.rfind(b"\n") + 1
        torn = data[end:]
        if torn:
            f.truncate(end)
            f.flush()
            os.fsync(f.fileno())
    dropped = 1 if torn.strip() else 0
    records = []
    for line in data[:end].splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            dropped += 1
    return records, dropped
