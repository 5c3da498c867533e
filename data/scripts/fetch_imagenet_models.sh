#!/usr/bin/env bash
# Fetch the ImageNet-pretrained VGG-16 Caffe weights (the reference's
# train-time warm start; SURVEY.md §2.5 "Model/data fetchers" — mount
# empty, no file:line exists) and convert them for aznet_tpu.
# Requires network egress + a pycaffe environment for the .caffemodel ->
# .npz extraction step (tools/convert_caffe.py documents the format).
# Usage: ./data/scripts/fetch_imagenet_models.sh
set -euo pipefail
cd "$(dirname "$0")/.."
mkdir -p imagenet_models && cd imagenet_models

VGG16_URL="https://www.robots.ox.ac.uk/~vgg/software/very_deep/caffe/VGG_ILSVRC_16_layers.caffemodel"
PROTO_URL="https://gist.githubusercontent.com/ksimonyan/211839e770f7b538e2d8/raw/0067c9b32f60362c74f4c445a080beed06b07eb3/VGG_ILSVRC_16_layers_deploy.prototxt"

fetch() {
  if command -v curl >/dev/null; then curl -fL --retry 3 -O "$1"
  else wget "$1"; fi
}

[ -f VGG_ILSVRC_16_layers.caffemodel ] || fetch "$VGG16_URL"
[ -f VGG_ILSVRC_16_layers_deploy.prototxt ] || fetch "$PROTO_URL"

cat <<'EOF'
Downloaded Caffe VGG-16. To convert for aznet_tpu (needs pycaffe):
  python - <<'PY'
import caffe, numpy as np
net = caffe.Net('VGG_ILSVRC_16_layers_deploy.prototxt',
                'VGG_ILSVRC_16_layers.caffemodel', caffe.TEST)
np.savez('vgg16_caffe.npz', **{f'{k}_W': v[0].data for k, v in net.params.items()},
         **{f'{k}_b': v[1].data for k, v in net.params.items() if len(v) > 1})
PY
  python tools/convert_caffe.py --npz data/imagenet_models/vgg16_caffe.npz \
      --out data/imagenet_models/vgg16_params.msgpack
EOF
