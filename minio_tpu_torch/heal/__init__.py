"""Background healing: the MRF queue and the heal routine."""
