"""v2 cost plotter (reference: python/paddle/v2/plot/plot.py).

``Ploter`` accumulates (step, value) series and renders via matplotlib when
available; headless/no-matplotlib environments degrade to a text log, like
the reference's DISABLE_PLOT path.
"""
from __future__ import annotations

__all__ = ["Ploter"]


class PlotData(object):
    """One named series.  ``step``/``value`` stay plain mutable list
    attributes — the reference's public contract — behind this repo's
    own column-pair shape."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.step, self.value = [], []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(value)


class Ploter(object):
    def __init__(self, *args):
        self.__args__ = args
        self.__plot_data__ = {t: PlotData() for t in args}
        try:
            import matplotlib  # noqa: F401
            self.__disable_plot__ = False
        except Exception:
            self.__disable_plot__ = True

    def append(self, title, step, value):
        self.__plot_data__[title].append(step, value)

    def plot(self, path=None):
        if self.__disable_plot__:
            for t, d in self.__plot_data__.items():
                if d.step:
                    print(f"[plot] {t}: step={d.step[-1]} value={d.value[-1]}")
            return
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.figure()
        for t in self.__args__:
            d = self.__plot_data__[t]
            plt.plot(d.step, d.value, label=t)
        plt.legend()
        if path:
            plt.savefig(path)
        plt.close()

    def reset(self):
        for d in self.__plot_data__.values():
            d.reset()
