"""What the benchmark's tests share."""

CELLS = ("taxi.q1_q4", "tpch_sf10.q3", "tpch_sf10.q1_q6")
SCALE = {"taxi.q1_q4": 0.0005, "tpch_sf10.q3": 0.001,
         "tpch_sf10.q1_q6": 0.001}
SEED = 2 ** 31 + 12345
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "checks"}
