"""Drivers, one per traffic kind (a traffic file's "driver")."""
