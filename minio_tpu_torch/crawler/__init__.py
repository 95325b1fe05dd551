"""Data crawler and update tracker: slice 9b.  Only the tracker's seam
is here (updatetracker.py)."""
