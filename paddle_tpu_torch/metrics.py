"""Host-side streaming metrics (counterpart of ``paddle_tpu/metrics.py``).

They aggregate numpy results across batches on the host; the in-graph
per-batch values come from the metric ops (``accuracy``, ``auc``).
"""
from __future__ import annotations

import threading

import numpy as np


class MetricBase:
    def __init__(self, name=None):
        self._name = name or type(self).__name__

    def reset(self):
        raise NotImplementedError

    def update(self, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    """metrics.py:131 — weighted mean of per-batch accuracies."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no batches accumulated")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    """metrics.py ChunkEvaluator: streaming chunk F1."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).sum())
        self.num_label_chunks += int(np.asarray(num_label_chunks).sum())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).sum())

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    """metrics.py EditDistance: mean edit distance + instance error rate."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        d = np.asarray(distances)
        self.total_distance += float(d.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int((d > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no batches accumulated")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class Auc(MetricBase):
    """metrics.py:302 — host-side streaming ROC-AUC."""

    def __init__(self, name=None, curve="ROC", num_thresholds=200):
        super().__init__(name)
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        n = self.num_thresholds
        self.tp = np.zeros(n)
        self.fp = np.zeros(n)
        self.tn = np.zeros(n)
        self.fn = np.zeros(n)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_prob = np.asarray(preds[:, 1] if preds.ndim == 2
                              else preds.reshape(-1), dtype=np.float64)
        n = self.num_thresholds
        thresholds = (np.arange(n) + 1) / (n + 1)
        # Vectorized form of the per-threshold loop: a sample with score p
        # is predicted positive at threshold index i iff p > thresholds[i],
        # i.e. iff i < k where k = #{t : t < p} = searchsorted(t, p, 'left')
        # — the identical float comparison the loop made, so counts are
        # bitwise-equal.  One bincount per class replaces n boolean passes.
        k = np.searchsorted(thresholds, pos_prob, side="left")
        is_pos = labels > 0
        # cum[i] = #samples with k <= i  ->  predicted-negative at i
        cum_pos = np.cumsum(np.bincount(k[is_pos], minlength=n + 1))[:n]
        cum_neg = np.cumsum(np.bincount(k[~is_pos], minlength=n + 1))[:n]
        n_pos, n_neg = int(is_pos.sum()), int((~is_pos).sum())
        self.tp += n_pos - cum_pos
        self.fn += cum_pos
        self.fp += n_neg - cum_neg
        self.tn += cum_neg

    def eval(self):
        tpr = self.tp / np.maximum(self.tp + self.fn, 1)
        fpr = self.fp / np.maximum(self.fp + self.tn, 1)
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(abs(trapezoid(tpr, fpr)))


class LatencyStats(MetricBase):
    """Streaming latency percentiles (serving-era addition, same
    reset/update/eval contract as the reference metrics).

    Keeps a bounded ring of the most recent ``max_samples`` observations
    — percentiles reflect the current serving window, while ``count`` and
    ``total`` aggregate over the metric's whole lifetime.

    Thread-safe: engine worker threads update() concurrently, and an
    unguarded ring would interleave the append/_next bookkeeping (two
    threads appending past max_samples, or one clobbering the other's
    slot then double-advancing the cursor).  One lock covers the ring
    cursor AND the count/total pair so eval() never sees them torn."""

    def __init__(self, name=None, max_samples=8192):
        super().__init__(name)
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._samples = []
            self._next = 0
            self.count = 0
            self.total = 0.0

    def update(self, seconds):
        s = float(seconds)
        with self._lock:
            if len(self._samples) < self.max_samples:
                self._samples.append(s)
            else:
                self._samples[self._next] = s
            self._next = (self._next + 1) % self.max_samples
            self.count += 1
            self.total += s

    def percentile(self, q):
        with self._lock:
            if not self._samples:
                raise ValueError("no samples accumulated")
            arr = np.asarray(self._samples)
        return float(np.percentile(arr, q))

    def eval(self):
        with self._lock:
            if self.count == 0:
                raise ValueError("no samples accumulated")
            arr = np.asarray(self._samples)
            count, total = self.count, self.total
        return {"count": count,
                "mean": total / count,
                "p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99))}


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.asarray(preds).reshape(-1) > 0.5
        labels = np.asarray(labels).reshape(-1) > 0.5
        self.tp += int(np.sum(preds & labels))
        self.fp += int(np.sum(preds & ~labels))

    def eval(self):
        return self.tp / max(self.tp + self.fp, 1)


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.asarray(preds).reshape(-1) > 0.5
        labels = np.asarray(labels).reshape(-1) > 0.5
        self.tp += int(np.sum(preds & labels))
        self.fn += int(np.sum(~preds & labels))

    def eval(self):
        return self.tp / max(self.tp + self.fn, 1)
