"""The traffic drivers, one for each ``kind`` of traffic file."""
