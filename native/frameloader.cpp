// tpuslam native frame loader.
//
// The analog of the reference's C++ Preprocessor host I/O
// (reference src/preprocessing/preprocessor.cpp:24-141): directory globbing,
// lexical ordering, and frame decode — restructured as a multi-threaded
// batch decoder that fills caller-provided buffers so Python-side prefetch
// never blocks on the GIL during decode.  Undistortion is NOT done here (it
// runs on-device from a precomputed gather map); this loader only produces
// grayscale uint8 frames.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this environment).
//
// Grayscale conversion of color inputs matches OpenCV's fixed-point
// BGR→GRAY coefficients (the reference converts with cv::cvtColor,
// preprocessor.cpp:136): y = (4899·R + 9617·G + 1868·B + 8192) >> 14.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <filesystem>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace fs = std::filesystem;

namespace {

struct ThreadPool {
    explicit ThreadPool(unsigned n) {
        for (unsigned i = 0; i < n; ++i) {
            workers.emplace_back([this] {
                for (;;) {
                    std::function<void()> job;
                    {
                        std::unique_lock<std::mutex> lk(mu);
                        cv.wait(lk, [this] { return stop || !jobs.empty(); });
                        if (stop && jobs.empty()) return;
                        job = std::move(jobs.front());
                        jobs.pop();
                    }
                    job();
                }
            });
        }
    }
    ~ThreadPool() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv.notify_all();
        for (auto& w : workers) w.join();
    }
    void submit(std::function<void()> job) {
        {
            std::lock_guard<std::mutex> lk(mu);
            jobs.push(std::move(job));
        }
        cv.notify_one();
    }

    std::vector<std::thread> workers;
    std::queue<std::function<void()>> jobs;
    std::mutex mu;
    std::condition_variable cv;
    bool stop = false;
};

inline uint8_t rgb_to_gray(uint8_t r, uint8_t g, uint8_t b) {
    return static_cast<uint8_t>((4899 * r + 9617 * g + 1868 * b + 8192) >> 14);
}

// Decode a PNG file into a grayscale uint8 buffer (returns 0 on success).
int decode_png_gray(const char* path, uint8_t* out, int out_h, int out_w) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return 1;
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) { std::fclose(fp); return 2; }
    png_infop info = png_create_info_struct(png);
    if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); std::fclose(fp); return 2; }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        std::fclose(fp);
        return 3;
    }
    png_init_io(png, fp);
    png_read_info(png, info);
    png_uint_32 w = png_get_image_width(png, info);
    png_uint_32 h = png_get_image_height(png, info);
    int color = png_get_color_type(png, info);
    int depth = png_get_bit_depth(png, info);
    if (static_cast<int>(h) != out_h || static_cast<int>(w) != out_w) {
        png_destroy_read_struct(&png, &info, nullptr);
        std::fclose(fp);
        return 4;
    }
    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    png_set_strip_alpha(png);
    png_read_update_info(png, info);
    int channels = png_get_channels(png, info);
    std::vector<uint8_t> row(static_cast<size_t>(w) * channels);
    for (png_uint_32 y = 0; y < h; ++y) {
        png_read_row(png, row.data(), nullptr);
        uint8_t* dst = out + static_cast<size_t>(y) * w;
        if (channels == 1) {
            std::memcpy(dst, row.data(), w);
        } else {  // RGB(A stripped)
            for (png_uint_32 x = 0; x < w; ++x) {
                const uint8_t* p = row.data() + static_cast<size_t>(x) * channels;
                dst[x] = rgb_to_gray(p[0], p[1], p[2]);
            }
        }
    }
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 0;
}

int decode_jpeg_gray(const char* path, uint8_t* out, int out_h, int out_w) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return 1;
    jpeg_decompress_struct cinfo;
    jpeg_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr);
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, fp);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_GRAYSCALE;  // libjpeg's own BT.601 conversion
    jpeg_start_decompress(&cinfo);
    if (static_cast<int>(cinfo.output_height) != out_h ||
        static_cast<int>(cinfo.output_width) != out_w) {
        jpeg_destroy_decompress(&cinfo);
        std::fclose(fp);
        return 4;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* rowptr = out + static_cast<size_t>(cinfo.output_scanline) * out_w;
        jpeg_read_scanlines(&cinfo, &rowptr, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return 0;
}

struct Loader {
    std::vector<std::string> files;
    int height = 0;
    int width = 0;
    ThreadPool pool{std::max(2u, std::thread::hardware_concurrency() / 2)};
};

int probe_png_size(const char* path, int* h, int* w) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return 1;
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        std::fclose(fp);
        return 3;
    }
    png_init_io(png, fp);
    png_read_info(png, info);
    *w = static_cast<int>(png_get_image_width(png, info));
    *h = static_cast<int>(png_get_image_height(png, info));
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 0;
}

int probe_jpeg_size(const char* path, int* h, int* w) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return 1;
    jpeg_decompress_struct cinfo;
    jpeg_error_mgr jerr;
    cinfo.err = jpeg_std_error(&jerr);
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, fp);
    jpeg_read_header(&cinfo, TRUE);
    *w = static_cast<int>(cinfo.image_width);
    *h = static_cast<int>(cinfo.image_height);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return 0;
}

bool is_jpeg(const std::string& p) {
    auto dot = p.rfind('.');
    if (dot == std::string::npos) return false;
    std::string ext = p.substr(dot);
    std::transform(ext.begin(), ext.end(), ext.begin(), ::tolower);
    return ext == ".jpg" || ext == ".jpeg";
}

}  // namespace

extern "C" {

// Open a directory of .png/.jpg frames (lexically sorted, like the
// reference preprocessor.cpp:34-41).  Returns a handle or nullptr.
void* fl_open_dir(const char* dir_path, int* n_frames, int* height, int* width) {
    auto* L = new Loader();
    std::error_code ec;
    for (const auto& entry : fs::directory_iterator(dir_path, ec)) {
        if (!entry.is_regular_file()) continue;
        std::string p = entry.path().string();
        auto dot = p.rfind('.');
        if (dot == std::string::npos) continue;
        std::string ext = p.substr(dot);
        std::transform(ext.begin(), ext.end(), ext.begin(), ::tolower);
        if (ext == ".png" || ext == ".jpg" || ext == ".jpeg") L->files.push_back(p);
    }
    if (ec || L->files.empty()) {
        delete L;
        return nullptr;
    }
    std::sort(L->files.begin(), L->files.end());
    int rc = is_jpeg(L->files[0])
                 ? probe_jpeg_size(L->files[0].c_str(), &L->height, &L->width)
                 : probe_png_size(L->files[0].c_str(), &L->height, &L->width);
    if (rc != 0) {
        delete L;
        return nullptr;
    }
    *n_frames = static_cast<int>(L->files.size());
    *height = L->height;
    *width = L->width;
    return L;
}

// Decode frames [start, start+count) into `out` (count × H × W uint8,
// C-contiguous) using the pool.  Returns 0 on success, else the first
// nonzero decoder status.
int fl_decode_batch(void* handle, int start, int count, uint8_t* out) {
    auto* L = static_cast<Loader*>(handle);
    if (start < 0 || start + count > static_cast<int>(L->files.size())) return 5;
    std::atomic<int> status{0};
    std::atomic<int> remaining{count};
    std::mutex done_mu;
    std::condition_variable done_cv;
    for (int i = 0; i < count; ++i) {
        L->pool.submit([&, i] {
            const std::string& path = L->files[start + i];
            uint8_t* dst = out + static_cast<size_t>(i) * L->height * L->width;
            int rc = is_jpeg(path)
                         ? decode_jpeg_gray(path.c_str(), dst, L->height, L->width)
                         : decode_png_gray(path.c_str(), dst, L->height, L->width);
            if (rc != 0) {
                int expected = 0;
                status.compare_exchange_strong(expected, rc);
            }
            if (remaining.fetch_sub(1) == 1) {
                std::lock_guard<std::mutex> lk(done_mu);
                done_cv.notify_all();
            }
        });
    }
    std::unique_lock<std::mutex> lk(done_mu);
    done_cv.wait(lk, [&] { return remaining.load() == 0; });
    return status.load();
}

void fl_close(void* handle) {
    delete static_cast<Loader*>(handle);
}

}  // extern "C"
