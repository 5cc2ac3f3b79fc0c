"""Models: FedYOLOv3 and its parameter templates."""
