"""Host-side dataset, preprocessing and the batch pipeline to the card."""
