"""The examples of the port, run as ``python -m repro_torch.examples.<name>
[--device cpu]`` (on the card unless ``--device cpu``):

- :mod:`.quickstart` — the paper's §4 worked example and the quality
  guarantee;
- :mod:`.log_analytics` — daily log summarization and on-demand interval
  histograms through ``summarize_tiles``, ``HistogramStore`` and
  ``TenantRegistry``;
- :mod:`.serve_calibrated` — batched serving and histogram-calibrated int8
  scales through ``Engine.calibrate``;
- :mod:`.train_lm` — LM training with quantile clipping and compression
  through ``Trainer``.

Each ports the reference's ``examples/<name>.py``, prints what it prints
and ends with its ``... OK``.  Each also names the printed numbers that
another run need not repeat: ``CLOCK_FIELDS``, those read off the wall
clock or a race with a worker thread, and ``MODEL_FIELDS``, those computed
by the model's floating-point arithmetic (equal only up to the order of
its reductions); every other number is a count or a histogram's, and
repeats bit for bit.  Each is a regex whose group 1 is the number;
:func:`split_fields` takes them out of a printout."""
import re

__all__ = ["split_fields"]


def split_fields(text: str, fields) -> tuple[str, list[str]]:
    """``text`` with the number of each match of ``fields`` replaced by
    ``#``, and those numbers as printed, pattern by pattern in order."""
    numbers = []

    def cut(m):
        numbers.append(m.group(1))
        start, end = m.start(1) - m.start(0), m.end(1) - m.start(0)
        return m.group(0)[:start] + "#" + m.group(0)[end:]

    for pattern in fields:
        text = re.sub(pattern, cut, text, flags=re.M)
    return text, numbers
