"""Physical, workload and target-hardware constants.

Workload constants (duty factor / toggle rate / clock) follow Sec. III-E of the
paper: duty factor of critical-path cells is 0.4-0.6 and toggle rate 0.006-0.009
under a real NN inference trace; the paper uses the averages, so we adopt the
midpoints as defaults (overridable in :class:`repro_torch.core.avs.LifetimeConfig`).
"""

# --- physical constants -----------------------------------------------------
KB_EV = 8.617333262e-5      # Boltzmann constant [eV/K]

# --- paper's accelerator operating point (Sec. V-A) -------------------------
V_NOM = 0.90                # nominal supply voltage [V]
V_MAX = 1.02                # end-of-life supply voltage reached by AVS [V]
V_STEP = 0.010              # AVS voltage increment [V]
T_CLK = 1.6e-9              # clock period [s]
D_CRIT_NOM = 1.542e-9       # nominal critical-path delay at (V_NOM, fresh) [s]
T_AMB = 298.15              # 25 degC [K]
LIFETIME_S = 10 * 365.25 * 24 * 3600.0   # 10-year product lifetime [s]

# --- workload activity (Sec. III-E, Fig. 4e) --------------------------------
DUTY_FACTOR = 0.5           # midpoint of the measured 0.4-0.6 range
TOGGLE_RATE = 0.0075        # midpoint of the measured 0.006-0.009 range
TRANSITION_TIME = 0.10e-9   # output transition (10%-90%) [s], HSPICE-typical

# --- policy defaults (Sec. IV-B) --------------------------------------------
DEFAULT_MAX_LOSS_PCT = 0.5  # default tolerable accuracy loss [% points]

# --- systolic array (Sec. V-A) ----------------------------------------------
ARRAY_DIM = 256             # 256x256 PEs
PE_IN_BITS = 8              # 8-bit multiplier inputs
PE_ACC_BITS = 32            # 32-bit accumulator
