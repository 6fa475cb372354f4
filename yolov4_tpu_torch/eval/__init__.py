"""COCO evaluation: the port's first-party COCOeval."""
