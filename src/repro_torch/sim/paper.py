"""The paper's published numbers, verbatim — ground truth for validation.

AraXL (Kunhi Purayil, Perotti, Fischer, Benini; 2025), 22 nm, TT/0.8V/25C.
"""

# Table II — area breakdown [kGE] per configuration (16/32/64 lanes)
TABLE_II_KGE = {
    16: {"clusters": 11354, "cva6": 936, "glsu": 291, "ringi": 25, "reqi": 34,
         "total": 12641},
    32: {"clusters": 22708, "cva6": 901, "glsu": 618, "ringi": 44, "reqi": 81,
         "total": 24352},
    64: {"clusters": 45415, "cva6": 931, "glsu": 1385, "ringi": 76, "reqi": 144,
         "total": 47950},
}

# Table III — PPA comparison (AraXL rows)
TABLE_III = {
    # lanes: (freq GHz, max perf GFLOPs, energy eff GFLOPs/W, area eff GFLOPs/mm2)
    16: (1.40, 44.3, 39.6, 17.4),
    32: (1.40, 87.2, 40.4, 17.8),
    64: (1.15, 146.0, 40.1, 15.1),
}
ARA2_16 = (1.08, 34.2, 30.3, 11.6)
VITRUVIUS_8 = (1.40, 22.4, 47.3, 17.23)

# §IV-B / Fig. 6 headline numbers
FMATMUL_UTIL_64L_LONG = 0.99       # ">99% utilization" / "up to 99%"
FCONV2D_UTIL_64L_LONG = 0.97
SOFTMAX_SCALE_64L = 7.3            # normalized to 8-lane Ara2, 512 B/lane
FDOT_SCALE_64L = 6.1
FDOT_SCALE_64L_16KIB = 7.6         # 16384 B/lane, 16 strip iterations
LONG_VECTOR_REGIME_B_PER_LANE = 128

# §IV-C / Fig. 7 — utilization drop upper bounds with interface cuts
GLSU_CUT_REGS = 4                  # +8 cycles request-response
GLSU_MAX_DROP = 0.015
REQI_CUT_REGS = 1                  # +2 cycles ack
REQI_DROP_FCONV_128 = 0.05
REQI_DROP_JACOBI_128 = 0.03
RINGI_CUT_REGS = 1                 # +1 cycle/hop
RINGI_MAX_DROP_LONG = 0.014
OVERALL_LONG_VECTOR_DROP = 0.02    # "less than 2% in the long-vector regime"

# §V conclusions
ENERGY_EFF_64L = 40.1
FREQ_64L = 1.15
