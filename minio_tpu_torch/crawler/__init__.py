"""Data crawler and update tracker: slice 9d.  Only the tracker's seam
is here (updatetracker.py)."""
