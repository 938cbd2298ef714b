"""SuGaR's field machinery and surface-regularisation losses."""
