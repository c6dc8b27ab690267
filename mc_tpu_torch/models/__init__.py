"""Model families beyond GBM (port of ``mc_tpu/models/``).

``heston``: the Heston stochastic-volatility family, full-truncation Euler
and Andersen QE, with its (S, v, state) trajectories.  The other families
of ``mc_tpu/models/`` are still to port (ROADMAP.md queue B, item 13).
"""
