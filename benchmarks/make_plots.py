"""Generate benchmark plots from benchmarks/results CSVs.

Analogue of the reference's parseAndPlot.py module-level plot regeneration
(reference: parseAndPlot.py:513-516): reads the reference-format CSVs
written by run_benchmarks.py and renders timing/accuracy plots into
benchmarks/plots/.
"""

import os
import sys

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from interiorpoint.utils.csvio import read_results
from interiorpoint.utils.plotting import (
    calculate_average_relative_error, plot_backtrack_distribution,
    plot_family, plot_timing_comparison)

RESULTS = os.path.join(os.path.dirname(__file__), "results")
PLOTS = os.path.join(os.path.dirname(__file__), "plots")
# Sweep dimensions, in run_benchmarks.py order; the reference CSV format
# records only (num_tests, N), so the dims axis is recovered by slicing
# this list to the row count (same convention as parseAndPlot.py).
SWEEP_DIMS = [100, 500, 1000, 2000, 3000, 5000]


def _dims_for(t):
    return SWEEP_DIMS[:t.shape[0]]


def main():
    os.makedirs(PLOTS, exist_ok=True)
    for suite in ("LP", "QP", "SOCP"):
        path = os.path.join(RESULTS, f"testResults_ours_{suite}.csv")
        if not os.path.exists(path):
            continue
        t = read_results(path)
        series = [t]
        labels = ["interiorpoint"]
        orc = os.path.join(RESULTS, f"testResults_oracle_{suite}.csv")
        if os.path.exists(orc):
            series.append(read_results(orc))
            labels.append("oracle (scipy-HiGHS)")
        ax = plot_timing_comparison(series, _dims_for(t), labels=labels,
                                    title=f"{suite} solve time vs n")
        ax.figure.savefig(os.path.join(PLOTS, f"{suite.lower()}_timing.png"),
                          dpi=120, bbox_inches="tight")
        plt.close(ax.figure)
        # the reference's full six-style family (parseAndPlot.py:177-409)
        written = plot_family(series, _dims_for(t), labels, suite, PLOTS)
        print(f"{suite}: wrote timing plot + {len(written)}-style family")

    # LP accuracy vs oracle
    tv = os.path.join(RESULTS, "testResults_ours_LPValues.csv")
    ov = os.path.join(RESULTS, "testResults_oracle_LPValues.csv")
    if os.path.exists(tv) and os.path.exists(ov):
        err = calculate_average_relative_error(read_results(ov),
                                               read_results(tv))
        print(f"LP average relative error vs oracle: {err:.3e}")
        with open(os.path.join(RESULTS, "lp_accuracy.txt"), "w") as f:
            f.write(f"LP average relative error vs scipy-HiGHS: {err:.6e}\n")

    lt = os.path.join(RESULTS, "testResults_ours_LASSOTimes.csv")
    if os.path.exists(lt):
        t = read_results(lt)
        ax = plot_timing_comparison([t], _dims_for(t),
                                    labels=["interiorpoint"],
                                    title="LASSO (30 batched) solve time vs n")
        ax.figure.savefig(os.path.join(PLOTS, "lasso_timing.png"),
                          dpi=120, bbox_inches="tight")
        plt.close(ax.figure)
        print("LASSO: wrote timing plot")

    # backtrack-count distribution (reference instrumentation:
    # testing/plots/backtrack_distribution.png), recorded by
    # run_benchmarks.py from IPMResult.bt_hist
    bh = os.path.join(RESULTS, "backtrack_hist.csv")
    if os.path.exists(bh):
        hist = np.loadtxt(bh, delimiter=",")
        ax = plot_backtrack_distribution(
            hist, label="LP benchmark backtrack distribution")
        ax.figure.savefig(os.path.join(PLOTS, "backtrack_distribution.png"),
                          dpi=120, bbox_inches="tight")
        plt.close(ax.figure)
        print("wrote backtrack distribution")


if __name__ == "__main__":
    main()
