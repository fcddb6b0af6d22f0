"""Field-space evaluation: metrics, batched and symmetry-averaged prediction, and the suite eval."""
