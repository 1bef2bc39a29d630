"""The viewer: the live page and server, the editor's scene rendering,
post-processing, keyframes, offline renders, JPEG and MJPEG video, and
mesh extraction."""
