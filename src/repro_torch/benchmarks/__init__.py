"""The paper-table benchmarks on the port (ports of the reference's
``benchmarks/table1_aging.py``, ``table2_policy.py``, ``fig5_curves.py``
and ``fig1b_ber.py``, with their PASS/FAIL checks and tolerances).

Each runs as ``python -m repro_torch.benchmarks.<name> [--device cpu]``
(the card by default) and exits non-zero when a check fails; its
``evaluate(device)`` returns the rows and checks.
"""
