"""Background healing: the MRF queue, the heal routine and the
fresh-disk monitor; resumable admin heal sequences (``sequence``)."""
