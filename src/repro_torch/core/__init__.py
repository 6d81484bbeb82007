"""ColRel core: the paper's contribution as torch and numpy modules.

  topology      D2D client graphs (ring / FCT / ER / clusters / ...)
  connectivity  Bernoulli intermittent uplink model τ_i ~ Bern(p_i)
  opt_alpha     OPT-α relay-weight optimization (paper Alg. 3)
  relay         local consensus Δx̃ = A·Δx + fused relay∘aggregate path
  aggregation   PS strategies (colrel / fedavg variants) + server momentum
"""
