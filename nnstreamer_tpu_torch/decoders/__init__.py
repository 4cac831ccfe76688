"""Decoder sub-plugins for tensor_decoder (image_labeling, bounding_boxes)."""
