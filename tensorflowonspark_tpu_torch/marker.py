"""Feed-queue sentinel markers — the port's copy of
``tensorflowonspark_tpu/marker.py``.

Reference: ``tensorflowonspark/marker.py`` (SURVEY.md §2 "Feed markers") —
sentinels pushed through the input queue so the consumer (:class:`DataFeed`)
can detect partition/epoch boundaries and end-of-feed without a side channel.

Difference from the reference: queue items are *record batches* (lists), not single
records (the reference's per-record pickle through a manager proxy is its
known feed bottleneck — SURVEY.md §7.3). Markers still travel the queue as
bare objects between batches.
"""


class Marker(object):
    """Base class for all feed-queue sentinels."""

    def __repr__(self):  # pragma: no cover - debug aid
        return "<{}>".format(type(self).__name__)


class EndPartition(Marker):
    """End of one input partition (reference: ``marker.EndPartition``).

    ``DataFeed.next_batch`` returns a short batch when it sees one, so batch
    boundaries never straddle partitions/epochs.
    """


class EndFeed(Marker):
    """End of the entire feed: no more data will ever arrive.

    Pushed by ``shutdown()`` so background consumers unblock deterministically
    (the reference signals this with ``None`` items; an explicit type is
    self-documenting and survives queues that carry legitimate ``None``\\ s).
    """
