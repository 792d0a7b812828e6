"""Map geometry and the correlated sky synthesis."""
