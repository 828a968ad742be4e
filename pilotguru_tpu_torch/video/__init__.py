"""Frame input of the port: image lists and video readers (its own copies),
PNG on zlib and cv2-equal image processing, none of which needs cv2."""
