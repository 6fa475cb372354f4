"""COCO data, transforms and the host loader."""
