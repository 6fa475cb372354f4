"""Box geometry, greedy NMS (plain version and Hopper kernel), postprocess."""
