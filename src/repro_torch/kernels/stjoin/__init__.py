"""The join kernels (``repro/kernels/stjoin/stjoin.py``): K1, the dense
best-match join (replaces ``stjoin_pallas``), and the fused streaming
passes of ``mode="fused"``, K2 (votes and packed TSA2 words, replaces
``stjoin_vote_fused_flat``), K4 (the raw similarity scatter, replaces
``stjoin_sim_fused_flat``) and K7 (one row panel of that scatter in both
orientations, for ``sim_mode="topk"``; replaces
``stjoin_sim_panel_fused_flat``), and their index-pruned twins for
``use_index=True``: K10 (replaces ``stjoin_pallas_pruned``), K11, K12
and K13 (replace ``stjoin_*_fused_pruned_flat``), which run the same
block bodies over the tiles a plan keeps.  All of them run one sweep
that skips, per group of 8 consecutive reference points (K1 / K10: of
the flattened points), the chunks of 8 candidate points whose valid times
all lie farther than eps_t (``ref.chunk_time_bounds``, built on the card
by ``ops.chunk_time_bounds``; ``ref.panel_skip_ref``), with the same
matches, weights and indices (K10 and K11 are K1's and K2's kernels over
a plan; K4 and K12 are the forward blocks of K7's and K13's kernel over
every row).

Numerics of the sweep, which the CUDA kernels, their plain versions
(``ref.py``) and the Pallas kernels share:

* **The cylinder test squares the radius.**  A pair matches when
  ``d2 <= eps_sp * eps_sp`` (both sides rounded to float32) and
  ``|dt| <= eps_t``; the square root is taken only for the weight
  ``w = 1 - sqrt(d2) / eps_sp``.  The plain join of ``core.geometry``
  tests ``sqrt(d2) <= eps_sp`` instead: the two can disagree on a point
  that lies on the boundary to within an ulp, so each port matches its
  own counterpart and neither is swapped for the other.
* **The first index wins a tie.**  Candidate points are walked in index
  order with a strict ``>`` on the running maximum, which is argmax's
  first-index rule.  Non-matching pairs weigh -1, so a boundary match
  whose weight rounds to 0 (or just below) still yields ``best_w = 0``
  and ``best_idx = -1``, as in the reference.  A redesign that compares
  ``d2`` and takes one square root per (p, c) must still take the
  argmax over the *rounded* ``w``: two different ``d2`` can round to the
  same ``w``, and the first index must win that tie.
* **No FMA contraction.**  ``d2 = dx*dx + dy*dy`` is rounded after each
  product and after the sum (``__fmul_rn`` / ``__fadd_rn`` and
  ``-fmad=false``), square root and division are IEEE-rounded
  (``__fsqrt_rn`` / ``__fdiv_rn``, no ``--use_fast_math``), so the kernel
  matches the plain PyTorch version bit for bit on the card.
* **The time-window skip is exact.**  A (group, chunk) pair is skipped
  only when one of them holds no valid time or ``q_min - p_max > eps_t``
  or ``p_min - q_max > eps_t`` in float32, the pair test's own rounded
  subtraction; rounding is monotone and odd, so every pair it skips has
  ``|fl(t_p - t_q)| > eps_t`` (a NaN bound skips nothing).  The chunks a
  point keeps are walked in ascending index, so the first index still
  wins a tie.

Numerics of the fused consumers, which fix an order the Pallas kernels do
not (so the port matches them to 1e-5, and its kernels match their plain
versions bit for bit):

* **The delta_t refine** drops a run of consecutive matched points of a
  (row, candidate) pair when ``max(t) - min(t) < delta_t`` over the run,
  the test of ``core.geometry.filter_delta_t``; ``delta_t <= 0`` keeps
  every run.
* **A vote is summed over the candidates in ascending order**, one
  rounded add at a time from +0.0 (the Pallas kernel sums blocks of
  candidates, then the blocks).
* **A similarity cell adds its weights in (t, m, c) order**, as the
  materialize path's scatter does, so both modes give the same matrix,
  and K7's panels hold K4's cells bit for bit.
"""
