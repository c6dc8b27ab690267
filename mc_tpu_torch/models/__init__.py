"""Model families beyond GBM (port of ``mc_tpu/models/``).

``heston``: the Heston stochastic-volatility family, full-truncation Euler
and Andersen QE, with its (S, v, state) trajectories.  ``merton``: Merton
jump-diffusion, the exact terminal draw and the Euler loop, with its (S,
state) trajectories.  ``bates``: Bates SVJ, Heston's schemes with Merton's
jump.  ``cev``: CEV local vol, level-space Euler with an absorbing zero.
``localvol``: a sigma(S, t) knot surface, log-Euler, with its (S, state)
trajectories.  ``sabr``: SABR, the log-forward under a CEV backbone and an
exact lognormal vol.  ``term``: per-step rate and vol curves.
``dividends``: GBM with discrete cash dividends.  ``vasicek``: equity under
Vasicek short rates, exact in law, discounted pathwise, with its (S, x, y,
state) trajectories.  ``basket``: a correlated d-asset basket (d up to 32),
with its (B, state) trajectories.  The other families of ``mc_tpu/models/``
(rainbow, FX) are still to port (ROADMAP.md queue B, item 13).
"""
