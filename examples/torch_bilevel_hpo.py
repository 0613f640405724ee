"""Example: hyperparameter optimisation with SHINE (paper §3.1), on the
PyTorch port.

The port's counterpart of ``examples/bilevel_hpo.py``: optimises the l2
regularisation strength of a logistic-regression model on a synthetic
20news-shaped dataset with the HOAG outer loop, comparing the full-CG
backward against SHINE's shared L-BFGS inverse (zero backward HVPs) and
SHINE-OPA.  Each mode resolves to a cotangent estimator registered in
``repro_torch.implicit.ESTIMATORS``.

Run:  PYTHONPATH=src python examples/torch_bilevel_hpo.py [--device cpu]
(the default device is the CUDA card).
"""

import argparse

from repro_torch.core.bilevel import HOAGConfig, make_logreg_problem, run_hoag
from repro_torch.core.solvers import SolverConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    problem = make_logreg_problem(n_train=1500, n_val=400, n_test=400,
                                  dim=500, density=0.05, seed=0,
                                  device=args.device)
    for mode in ("full_cg", "shine", "shine_opa", "jfb"):
        cfg = HOAGConfig(
            mode=mode, outer_steps=10, outer_lr=0.5,
            tol_decrease=0.99 if mode == "full_cg" else 0.78,
            inner=SolverConfig(max_steps=300, tol=1e-4, memory=30))
        hist = run_hoag(problem, theta0=1.0, cfg=cfg, verbose=False)
        last = hist[-1]
        print(f"{mode:10s} theta*={last.theta:.3e} "
              f"val={last.val_loss:.4f} test={last.test_loss:.4f} "
              f"wall={last.wall_time:.1f}s "
              f"bwd_hvp_calls={sum(h.backward_hvp_calls for h in hist)}")


if __name__ == "__main__":
    main()
