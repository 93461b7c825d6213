"""The paper's primary contribution: aging-aware adaptive voltage scaling.

* :mod:`aging`      — BTI/HCI compact models, history-aware accumulation
* :mod:`delay`      — critical-path model + ternary degree-6 polynomial
* :mod:`avs`        — lifetime AVS simulator
* :mod:`ber`        — delay -> BER mapping and inversion
* :mod:`resilience` — BER -> accuracy curves, per-operator tolerances
* :mod:`policy`     — baseline & fault-tolerant voltage-scaling policies
* :mod:`scenario`   — mission profiles and trajectories
* :mod:`power`      — lifetime power / V_eff model
* :mod:`fleet`      — FleetRuntime (N devices x O domains)
* :mod:`runtime`    — AgingAwareRuntime, the one-device view
* :mod:`artifacts`  — the calibration artifact
"""
